#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, config-file entry points,
pretraining, import, export and parallel paths on one NVIDIA H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --repeat-train N`` runs the phases up to the train
phase as the full run does, then the train phase N times, on the shared
synthetic arrays and on freshly made ones in turns, and exits 1 if any run
failed (a check for a fault that depends on what ran before).

Phases, each printing one JSON line ({"phase": ...}):

1. device  - needs a CUDA device of compute capability 9.0; prints the card's
             name and power limit as nvidia-smi gives them;
2. build   - compiles csrc/*.cu with nvcc for sm_90a (ops/_build.py);
3. kernels - holds each kernel against its plain PyTorch version at the
             shapes the main path gives it (the 256-frame chunk; the ragged
             tail is padded to it), in float32 with TF32 off and in
             bfloat16, and times both with CUDA events; the int8 stage at
             its three flagship shapes and the single int8 conv at 192x192x64
             (batch 8 and 256) must equal their plain versions, every element;
             the attention kernel on the views the ViT gives it (batch 256 x
             8 heads x 144 tokens x 256, and the 4-camera fusion block's 4
             heads), timed beside ``scaled_dot_product_attention`` on the
             same tensors (a yardstick; nothing in the port calls it); where a
             wrapper chooses between two hand-written kernels (the bf16
             tensor-core ones and the f32 CUDA-core ones), the served shapes
             must take the tensor-core kernel in bfloat16 and the CUDA-core
             kernel in float32 (the int8 ones: the int8 tensor-core kernel,
             the 4-channel first conv its packed-tap form), and general
             shapes per kernel (a stage at 9 -> 70 channels, attention at
             (5, 100, 72), the decoder at ragged sizes on either stride-2
             kernel, the int8 stage at ragged tiles on each of its kernels)
             are held against the plain versions too; the int8 weight
             packing equals its plain version; B1's three stages and B2 in
             bfloat16 at 1,024 rows, the batch a 4-camera chunk of 256
             samples gives them with its views folded in, each held to its
             plain version 256 rows at a time;
4. slice   - Predictor(Config(), use_fused=True) at full width (filters 64,
             192x192x4 frames -> 18 maps, bf16) on seeded random weights made
             by the weight bridge: three requests (256, 256, 100 frames) and
             one predict_movie call, with the kernels' launch counters
             zeroed just before and read just after (every conv of the path,
             the 4-channel first one and the decoder's two, must have taken a
             tensor-core kernel); then the staging movie, 16 chunks (4,096
             frames) of distinct frames made from the 612 (chunk j from
             frame 37 j on, wrapping, plus j / 64), through predict_movie at
             prefetch 1 and 4, the counters zeroed just before each and read
             just after, its peaks bit-equal to each chunk served alone from
             a device-resident tensor; per chunk, the stager's host fill of
             a pinned buffer (host clock), its pinned H2D copy (CUDA events
             on its copy stream) and the compute from a resident tensor
             (CUDA events); then the same frames
             through the "module" route (cuDNN), timed; then the first
             request's maps and peaks, fused vs module, in bf16 (as served,
             and equal to the main path's answer) and in float32 (TF32 off);
5. int8    - Predictor(use_quantized=True, use_fused=True), calibrated on
             the first 128 frames: the same requests and movie with the int8
             stage kernel's counter zeroed and read around them; then the
             "int8_resident" route, timed; then on one 256-frame chunk the
             fused maps against make_quantized_forward's (same scales) and
             both int8 routes against the bf16 module route's maps;
6. im2col  - the single int8 conv on the seeded inputs of
             scripts/exp_im2col_pallas.py: exactness, then microseconds per
             frame and effective TOP/s of the kernel and of its plain version;
7. lift    - lift_to_3d on peaks projected from known 3D points through
             four synthetic DLT cameras;
8. vit     - Predictor(Config(model_type=MODEL_18_POINTS_PER_WING_VIT)) at
             full width (patch 16, dim 256, depth 8, heads 8, dim_head 256,
             MLP 1024, bf16) on seeded weights: the same requests and movie
             on the "fused" route (every attention core on the attention
             kernel, its counter zeroed just before and read just after: 8
             launches a chunk), the staging movie as in the slice phase,
             then on the "module" route with the bf16
             softmax chain (the default) and with the exact softmax; then
             fused vs module on one chunk in float32 and in bf16;
9. vit4cam - ALL_CAMS_18_POINTS_VIT (192x192x16 -> 72 maps), full width, 64
             frames folded (chunk 64) and unfolded (chunk 128), fused vs
             module, the attention launches counted (12 and 48);
10. probes - the probe kernels as the two experiment scripts' mains run
             them, and the bisect script's other cases, each equal to its
             plain version (full_epilogue on weights packed once, before the
             timing), every probe of probes.cu on its 16-byte kernel (the
             by-kernel counters), each timed per call (what a caller sees,
             host dispatch included) and on the device alone (the calls
             captured in a CUDA graph and replayed), beside the byte-wise
             kernel it replaced on the same tensors and the one PyTorch call
             that computes the same function where there is one (clone for
             the four copies, torch.mul for grid_scale, torch.add(b, a,
             alpha=2) for int8_vector_arith, held equal first); then the
             host's launch path for int8_vector_arith through copies that
             each take one more of its costs out, timed in turns;
11. train  - flagship training at Config()'s defaults (filters 64, batch 8,
             bf16 compute over float32 parameters, augmentation with the
             separable warp on rotation buckets, JAX's default, dropout
             0.5, Adam 1e-3) through the port's entry
             points, all on the card: (a) build_dataset of 16 synthetic
             192x192 frames with 32 wing points (128 per-wing samples of
             192x192x4 -> 18, half of them validation; from arrays: the
             entry phase trains from the H5 file); (b) create_train_state and 3 + 20
             steps, every loss finite and every parameter moved, the 20
             timed with CUDA events (steps/s, frames/s); (c) with
             deterministic cuDNN, one float32 step (TF32 off, dropout 0,
             targets rendered from the peaks) on the card against the same
             step on the CPU: loss, gradients and updated parameters within
             the stated tolerances; (d) true resume: 3 steps, a checkpoint,
             restore_checkpoint into a fresh state, 2 steps, equal to 5 steps
             in one go, bit for bit; (e) make_eval_step over the validation
             split; (f) the trained parameters through
             basicnet_params_from_state_dict into Predictor(use_fused=True):
             one 256-frame chunk with the encoder-stage and decoder counters
             zeroed just before and read just after (every conv on a
             tensor-core kernel), its maps within 5% of max of the trained
             module's eval forward; (g) the warp alone on the step's frames
             in bf16, at batch 8 and 256: each call draws its bucket and
             matrices as the step does, then the separable warp (on that
             bucket's canvas) and the gather warp on the same matrices, in
             turns, each timed by CUDA events from an idle card; the bucket
             of every timed call, each bucket taken at least once; the
             separable warp in float32 on the card against the CPU, each
             bucket, within 1e-5; (h) the step timed with each warp in
             blocks of 10 steps (separable, gather, gather, separable);
12. trainer - the Trainer at Config() (filters 64, batch 8, augmentation
             and dropout on) on the train phase's 16 synthetic frames: 3
             epochs of 10 updates, then a second Trainer resuming the run
             directory to 5 epochs (it must start at epoch 3 with the step
             and Adam state restored); the run directory's files (the PNGs
             reported as skipped where matplotlib is missing); the epoch
             loop's time by the host clock around train() (synchronised),
             each epoch's, a validation pass's, and the step rate beside the
             train phase's bare step; then Predictor.from_checkpoint on the
             resumed run directory with use_fused=True: 256 frames with the
             encoder-stage and decoder counters zeroed just before and read
             just after, its maps within 5% of max of the module route on
             the same run directory;
13. entry  - the config-file entry points on the card, the contract file
             read and written by the port's own HDF5 reader and writer
             (data/h5.py; the machine has no h5py): (a) write_synthetic_h5
             of the train phase's 16 frames (32 wing points) in MATLAB's
             transposed dialect, read back with read_datasets, every dataset
             equal to the arrays written; (b) a Config() JSON at full width
             (filters 64, batch 8, augmentation and dropout on) with that
             file as its data_path, 2 epochs of 5 updates, run as
             ``python -m pose_estimation_amitai_torch.train.trainer cfg.json``
             in a child process with no --device: exit code 0, "training on
             cuda:0" on its output, the run directory's files, finite losses;
             (c) ``cli eval`` and ``cli infer --mat`` on that config, run
             directory and file on the default device: eval's L2 statistics
             finite, infer's .npz peaks of the samples' shape and finite;
             (d) the run directory through Predictor.from_checkpoint(
             use_fused=True) on one 256-frame chunk (each camera's frame
             with one wing's mask, and the flips) with the encoder-stage and decoder counters zeroed
             just before and read just after, its maps within 5% of max of
             the module route; (e) the reader's rate at a real file size: a
             256-frame uint8 box (256, 4, 192, 192, 5), 189 MB, written,
             read from a warm page cache by read_datasets and by np.fromfile
             of the same bytes, in turns, GB/s of each, the file deleted;
             and one deflated chunk (one synthetic frame of one camera as
             uint8, deflate level 4 as h5py's gzip) undone by the reader's
             filter path, MB/s. The seconds of the phase, the child, eval and infer;
14. multicam - ALL_CAMS_18_POINTS MultiCamNet at full width (filters 64,
             192x192x16 -> 72, torch flavour, bf16) through the Trainer: 2
             epochs of 5 updates, batch 8, per-view augmentation; its run
             directory served on 64 frames folded and unfolded, in float32
             with TF32 off (within 1e-4 of max) and in bf16 (within 1% of
             max, the argmax equal wherever the top-two gap exceeds 2e-4);
             then one forward each of TwoWingsNet, C2FPerWing and the tf
             flavour MultiCamNet with attention fusion, at full width and
             batch 8: finite maps of the right shapes;
15. zoo    - the BatchNorm families and the camera-matrix model at full
             width (bf16 compute over float32 parameters) on the train
             phase's 16 synthetic frames: (a) ResNetHeatmapNet
             (RESNET_18_POINTS_PER_WING, tpu flavour, ResNet50 3-4-6-3,
             192x192x4 -> 18) through the Trainer, 2 epochs of 5 updates,
             batch 8, Config's augmentation; its bare step timed; one
             float32 step on the card against the CPU (deterministic cuDNN:
             loss, gradients of the largest, updated parameters beyond what
             the gradients explain, running averages); its best_model.pt
             through Predictor.from_checkpoint (running averages threaded)
             on 256 + 256 + 100 frames and as a 612-frame movie, equal;
             (b) GPTResNet (GPTNET, 192x192x4 -> 18): 3 + 10 steps at batch
             8 (CUDA events), its trained variables served on the same 612
             frames; (c) FourCamDisentangled (ALL_CAMS_DISENTANGLED_PER_WING_CNN,
             filters 64, 192x192x16 -> 72, the 32 per-wing samples with their
             crop-adjusted cameras) through the Trainer as (a), augmentation
             on and each view's warp folded into its camera, the same
             float32 card-vs-CPU step, then served through
             Predictor(cameras=...) on the 32 tiled to 356 with their camera
             rows (256 + a padded 100), the padded tail's peaks equal to the
             same samples' inside the full chunk; then on the "fused" route:
             its rate, launches (B1 3, the ftl_fusion kernel 1 and its
             "gemm" composition 0, B2 1 a chunk),
             predict_movie equal to __call__, and a whole chunk's maps
             (1,024 view-rows) within 3% of max from the module route's in
             float32 (TF32 off), the bf16 module route's gap beside it;
16. vit_train - the ViT at full width (patch 16, dim 256, depth 8, heads 8,
             dim_head 256, MLP 1024, bf16 compute over float32 parameters,
             batch 8) on the train phase's 16 synthetic frames: (a)
             MODEL_18_POINTS_PER_WING_VIT (torch flavour) through the
             Trainer, 2 epochs of 5 updates, then 3 + 20 bare steps (CUDA
             events) beside the loop's steps/s; (b) one float32 step on the
             card against the CPU (TF32 off; loss within 1e-4 relative,
             gradients within 1e-3 of the largest); (c) its run directory
             through Predictor.from_checkpoint on "fused", the attention
             kernel's counter zeroed just before and read just after (8
             launches for the one chunk), its maps against "module" within
             the slice phase's bf16 tolerance; (d) one tf-flavour step with
             its fixed 0.1 attention dropout live: the kept share of the
             attention probabilities within 0.9 +- 0.01; (e)
             ALL_CAMS_18_POINTS_VIT (4 fusion blocks, 192x192x16 -> 72)
             through the Trainer, 1 epoch of 3 updates, then its bare step;
17. int8_generic - Predictor(use_quantized=True) off the flagship geometry at
             full width on seeded weights, calibrated on 32 frames, serving
             the 612-frame requests and movie: ViTPoseNet ('all' and
             'conv_only'), MultiCamNet (ALL_CAMS_18_POINTS, filters 64),
             ResNetHeatmapNet (its running averages), FourCamDisentangled
             (its cameras; the 4-camera models at chunk 64); frames/s and
             the median peak distance to the same model's bf16 module route
             (printed: seeded weights give near-flat maps); held on a chunk
             of 2: the calibration scales card vs CPU in float32 (within
             1e-5 relative), every quantised layer call card vs CPU on the
             CPU's input (bit-equal: the float64 sums of int8 products are
             exact), and the maps card vs CPU;
18. selfsup - SelfSupTrainer at Config() (inpainting BasicNet, 4 -> 4,
             filters 64, batch 8, bf16, augmentation, dropout 0.5) on the
             train phase's synthetic boxes as 64 five-channel crops: 3
             epochs of 10 updates (the validation loss must fall), then 3 +
             10 bare steps (CUDA events) beside the loop's steps/s; one
             float64 step card vs CPU on the same holed and clean crops
             (loss within 1e-4 relative, gradients within 1e-3 of the
             largest; the float32 step's differences, and the CPU's own
             float32 step against its float64 one, reported); a Trainer at Config() with pretrained_encoder_path at
             its run directory (the encoder equal to the snapshot before the
             first step, then 1 epoch of 5 updates); the run directory
             through Predictor.from_checkpoint(use_fused=True), the
             encoder-stage and decoder counters read around one chunk;
19. import - a reference-layout torch BasicNet (filters 64, 4 -> 18) and
             ViT (patch 16, dim 256, depth 8, heads 8, dim_head 256) built
             here from the seed, each saved as a checkpoint.pth dict and a
             traced TorchScript best_model.pth, imported (both equal) and
             served through Predictor.from_checkpoint(import_reference=True)
             on "module" and "fused" over the 612 frames, in float32 (TF32
             off, maps within 1e-4 of max of the reference module's forward)
             and bf16 (within 5%); B1, B2 and S1's counters around the bf16
             fused run; then (a) the flagship's seeded tree written as the
             JAX package's best_model.msgpack (weights.pack_flax_msgpack:
             flax's bytes), read back bit-equal by load_flax_checkpoint, and
             the run directory served through Predictor.from_checkpoint on
             "fused" as three requests (256, 256, 100), B1 and B2's counters
             around them, maps and peaks bit-equal to a Predictor of the tree
             in memory; (b) keras saves written by the port's HDF5 writer
             (data/h5.py) in model.save's layout and read back by its
             reader (no h5py or msgpack there): the tf basic_nn at Config()
             (filters 64, 4 -> 18) served on "module" in float32 (maps
             within 1e-4 of max of the CPU's on 2 frames), and the ViT at
             Config()'s widths through ``cli import`` to a snapshot, served
             on "fused" from the .h5 (import_reference=True; S1's counter
             around the bf16 run) and on "module" from the snapshot, the
             routes within 1e-4 (float32) and 5% (bf16) of max of each
             other; _keras_weight_list reads back the names and bits
             written;
20. export - the flagship's "module", "fused" and "int8_fused" (scales from
             128 frames) routes and the ViT's "fused" route exported at
             chunk 256 (deploy.export_predictor), loaded with
             load_exported(path, "cuda") and served over the 612 frames:
             peaks equal to the same route's Predictor wherever the top-two
             gap exceeds 2e-4, B1, B2, B3 and S1's counters around the
             loaded programs, frames/s of the loaded program beside the
             Predictor's, the artifact's bytes; then the float32 module,
             fused and ViT fused programs on one chunk (peak values within
             1e-4 of max);
21. parallel - the parallel strategies (parallel/) in this process on a
             one-rank NCCL group on card 0 (tcp://localhost, a free port), at
             full width: (a) the data-parallel step at Config() (batch 8,
             augmentation and dropout on) against the plain train step on the
             same batches, 3 steps under deterministic cuDNN (every loss
             within 1e-6 relative, the first step's parameters within what
             Adam's eps explains), then 3 + 10 steps of each, in turns, timed
             with CUDA events; the same check for RESNET_18_POINTS_PER_WING,
             its BatchNorm moments through the NCCL all-reduce (running
             averages within 1e-6 of the largest); (b) PipelinedViT at the
             ViT's full width (patch 16, dim 256, depth 8, heads 8, dim_head
             256) at pipe 1 with 4 microbatches: its float32 forward against
             apply_sequential (1e-4 of max), 3 + 10 steps of
             make_pipelined_train_step (bf16, timed), the trained weights
             through pipeline_params_to_vit served on "fused" over the 612
             frames with the attention kernel's counter zeroed just before
             and read just after, and held against "module" in float32
             (maps within 1e-4, peaks equal where the top-two gap exceeds
             2e-4); (c) ring_attention at seq 1 on the 4-camera ViT's fused
             sequence (64 x 576 tokens, 4 heads of 256) in float32 (1e-5 of
             max) and bf16 (3e-2) against reference_attention, and the MoE
             (dim 256, hidden 1024, 8 experts) at expert 1 on 64 x 144 tokens
             against apply_dense (1e-5 of max), each timed beside its
             one-process function; (d) Predictor(mesh=make_mesh((1,),
             "cuda"), use_fused=True) on the flagship over the 612 frames,
             peaks equal to the mesh-less fused Predictor's, frames/s beside
             its, the encoder-stage and decoder counters zeroed just before
             and read just after; (e) where the machine has 2 or more cards,
             a 2-rank NCCL world (one process a card) repeats one float32
             data-parallel step and the pipelined forward at pipe 2 against
             the one-rank results (the train phase's tolerances; 1e-4 of max).
             A line says how many ranks ran.

Then a {"kernels": [...]} line: for each kernel its launches on its path,
its error and times from this run, and ``bound_ms``, the least time the card
could take for the same call: the larger of its operations over the
published peak of their type and its bytes (each operand read once, the
output written once) over the published memory rate. ``library_ms`` is the time of the one PyTorch call
that computes the same function, where there is one (the attention kernel:
``scaled_dot_product_attention``; the probe rows: the sum over the probes
that have one, named in ``library_probes``, beside ``ms_of_library_probes``,
the kernels' time on the same probes), else null. The encoder-stage and
decoder rows also carry ``train_launches``, their launches on the trained
weights' chunk, and ``trainer_launches``, theirs on the Trainer's run
directory served through ``Predictor.from_checkpoint``, and
``entry_launches``, theirs on the run directory that ``python -m
...train.trainer cfg.json`` wrote in the entry phase; the attention row
``vit_train_launches``, its launches on the trained ViT's run directory.
The rows of B1, B2 and S1 carry ``movie_launches``, their launches in the
staging movie at prefetch 4 (16 chunks). The rows of B1, B2, B3 and S1
carry ``export_launches``, their launches
from the loaded serving artifacts; B1, B2 and S1 ``parallel_launches``, theirs
on the parallel phase's serving paths (the mesh Predictor, the
pipeline-trained ViT); B1 and B2 ``selfsup_launches`` (the
pretraining run directory's chunk) and, with S1, ``import_launches`` (the
imported reference checkpoints' 612 frames); B1 and B2
``jax_checkpoint_launches`` (the JAX run directory's 612 frames) and S1
``keras_launches`` (the keras ViT's). The rows of the kernels that
were redesigned for the tensor cores (all five that compute) also carry
``previous_ms``, the time in this run of the CUDA-core kernel they replace,
on the same tensors, and ``kernel``, which of the wrapper's kernels the
served shape took; B1 and B2 instead carry ``fma_ms``, the CUDA-core
kernels' time in this run, ``stage_ms`` and ``stage_bound_ms``, each
served call's time and bound, and ``conv_lib``: each conv kernel's
``-Xptxas -v`` registers and spills and the counts of ``HGMMA``,
``UTMALDG`` and ``HMMA`` in ``cuobjdump -sass`` of the library. The two
probe rows carry the same two fields (the
byte-wise kernels, and for full_epilogue its im2col weights packed at every
call; ``kernel`` lists each probe's), beside ``device_ms``,
``previous_device_ms`` and ``library_device_ms``, the device times from
CUDA-graph replays (``device_method``). The ``ftl_fusion`` row holds the
disentanglement model's middle at ``ftl.movie``'s shapes (256 samples,
1,024 view-rows of 48 x 48 x 256) on its kernel against the plain version,
with ``previous_ms`` the "gemm" composition it replaced, timed in the same
run, ``ptxas`` the kernel's registers and spills, and ``launches`` the zoo
phase's fused camera model's. Last
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
nonzero without the ok line.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
CHUNK = 256  # Predictor chunk: the batch of every flagship kernel call on the main path
FOLDED_VIEWS = 4  # a 4-camera chunk folds its views into B1's and B2's batch: 4 x CHUNK rows
REQUESTS = (256, 256, 100)  # slice-phase request sizes (ragged tail)
MOVIE_CHUNKS = 16  # the staging movie of the slice and vit phases: 4,096 frames
MOVIE_STRIDE = 37  # its chunk j starts at frame 37 j of the 612, wrapping
MOVIE_PREFETCH = (1, 4)  # predict_movie's prefetch, each timed
F32_ATOL = 1e-4  # kernel vs plain, float32: sums in another order only
BF16_RTOL = 1e-2  # kernel vs plain, bf16: of max|plain|; x1/x2 rounding flips
ROUTE_F32_ATOL = 1e-4  # fused vs module maps, float32, TF32 off
ROUTE_RTOL = 5e-2  # fused vs module maps, bf16: of max|module maps|
CLEAR_MIN = 0.9  # float32: least share of channels whose argmax is pinned
LIFT_RTOL = 1e-3  # 3D error, of the points' spread
CALIB_FRAMES = 128  # int8 calibration set: 4 batches of 32
# int8_fused vs make_quantized_forward maps, same scales: the tolerance of
# tests/test_pallas_qconv.py (a couple of int8 quanta of rounding order)
INT8_FUSED_RTOL = 5e-2  # of max|maps|
INT8_FUSED_CORR = 0.999
# an int8 route vs the bf16 module route's maps, of max|module maps|: the
# quantisation noise of 13 int8 layers on seeded random weights, set at
# about twice what an H100 run of this script showed (0.070 and 0.088)
INT8_VS_BF16_RTOL = 0.18
# published dense peaks of the H100 SXM, for bound_ms
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
VIT_F32_ATOL = 1e-4  # fused vs module normalised maps, float32, TF32 off
VIT4_FRAMES = 64  # one chunk of the 4-camera model each way
VIT4_FOLD_RTOL = 2e-2  # folded vs unfolded bf16 maps, of their range
PEAK_BYTES = 3.35e12
PREVIOUS_REPS = 2  # timed runs of a CUDA-core kernel on a served shape
# bytes of spill stores and loads each wgmma conv kernel may have (-Xptxas -v):
# at 112 registers a consumer thread the N = 128 tile's epilogue spills some
# address arithmetic; more than this is a regression
WGMMA_SPILL_BUDGET = {"conv3x3_wgmma_kernelILi64E": (0, 0),
                      "conv3x3_wgmma_kernelILi128E": (40, 92)}
# the train phase: synthetic frames x 4 cameras x 2 wings = 128 per-wing
# samples of 192x192x4; 32 wing points = 16 a wing + head and tail = 18 maps
TRAIN_FRAMES = 16
TRAIN_POINTS = 32
TRAIN_WARMUP = 3  # steps before the timed ones
TRAIN_STEPS = 20  # timed steps
RESUME_STEPS = (3, 2)  # steps before the checkpoint, steps after the restore
# the warp alone, separable against gather on the step's frames, in turns:
WARP_CALLS = {8: 30, 256: 24}  # timed calls a batch size (every bucket drawn)
WARP_WARMUP = 2  # calls of each before the timed ones
WARP_F32_ATOL = 1e-5  # the separable warp card vs CPU, float32 (TF32 off)
STEP_BLOCK = 10  # steps a block of the step timed with each warp (S, E, E, S)
# one float32 step (TF32 off, dropout 0, targets from peaks), card vs CPU:
TRAIN_LOSS_RTOL = 1e-4  # the loss
TRAIN_GRAD_RTOL = 1e-3  # each gradient tensor, of its largest element
# updated parameters where the two gradients have one sign, beyond what the
# gradients' own difference moves Adam's first update, lr * g / (|g| + eps):
# lr * eps * |g1 - g2| / ((|g1| + eps) (|g2| + eps)), large only where |g| is
# near eps; a flip of sign is allowed only where the CPU gradient is within
# TRAIN_GRAD_RTOL of zero, relative
TRAIN_PARAM_ATOL = 1e-6
ADAM_EPS = 1e-8  # torch.optim.Adam's and optax.adam's default
# the trainer phase: Trainer at Config() on the train phase's 16 frames
TRAINER_EPOCHS = (3, 5)  # the first run's epochs, the resumed run's
TRAINER_UPDATES = 10  # batches_per_epoch (accumulation 1)
VAL_REPS = 3  # timed validation passes after the run
# the entry phase: the trainer's module entry point on an H5 file
ENTRY_EPOCHS = 2
ENTRY_UPDATES = 5
ENTRY_TIMEOUT = 600  # seconds the child may take
READ_FRAMES = 256  # the reader's rate: a uint8 box of (256, 4, 192, 192, 5), 189 MB
READ_REPS = 5  # timed reads of each, in turns
# the multicam phase: ALL_CAMS_18_POINTS at full width
MULTICAM_EPOCHS = 2
MULTICAM_UPDATES = 5
MULTICAM_FRAMES = 64  # served folded and unfolded, one chunk each
MULTICAM_F32_RTOL = 1e-4  # folded vs unfolded maps, float32 (TF32 off), of max
MULTICAM_BF16_RTOL = 1e-2  # folded vs unfolded maps, bf16, of max
MULTICAM_GAP = 2e-4  # argmax equal wherever the top-two gap exceeds this
ZOO_BATCH = 8  # one forward of each other new model, full width
ZOO_EPOCHS = 2  # the zoo phase's Trainer runs: epochs of ZOO_UPDATES updates
ZOO_UPDATES = 5
ZOO_WARMUP = 3  # bare steps before the ZOO_STEPS timed ones
ZOO_STEPS = 10
ZOO_SERVED = 356  # camera-model samples served: a full chunk and a padded 100
ZOO_FTL_MAPS = CHUNK  # camera-model samples whose maps are compared: a chunk, 1,024 view-rows
ZOO_FTL_SHARE = 3e-2  # the fused route's bf16 maps' gap from float32's, of the largest value
FTL_SAMPLES = 256  # the ftl_fusion row: a chunk of ftl.movie, 1,024 view-rows of 48 x 48
FTL_LATENT = (48, 48, 256)  # its latent: 192 x 192 frames after B1, encoder width 256
FTL_RTOL = 2 ** -7  # kernel vs plain: one bf16 step of the output's largest value
# bytes of spill stores and loads ftl_fusion_kernel may have (-Xptxas -v): as
# built, <256> and <128> spill 76 / 80, <64> 296 / 300; more is a regression
FTL_SPILL_BUDGET = (296, 300)
ZOO_STATS_RTOL = 1e-4  # card vs CPU running averages, of each tensor's largest
# the vit_train phase: the ViT at full width on the train phase's frames
VIT_TRAIN_EPOCHS = 2
VIT_TRAIN_UPDATES = 5
VIT_TRAIN_WARMUP = 3  # bare steps before the timed ones
VIT_TRAIN_STEPS = 20
TF_DROPOUT_KEEP_ATOL = 0.01  # kept share of 0.1-dropped attention probabilities, of 0.9
VIT4_TRAIN_UPDATES = 3  # the 4-camera ViT: 1 epoch of these, then bare steps
VIT4_TRAIN_WARMUP = 1
VIT4_TRAIN_STEPS = 3
# the int8_generic phase
INT8G_CALIB = 32  # calibration frames (JAX's quantize_predict_fn takes at most 32)
INT8G_CHUNK_4CAM = 64  # the 4-camera models' chunk: float64 accumulators are 4x bf16
INT8G_CHECK = 2  # frames of the small chunk held card vs CPU
INT8G_SCALE_RTOL = 1e-5  # calibration scales card vs CPU, float32 compute, TF32 off
# int8_generic maps card vs CPU, of max|maps|: each quantised layer is bit-equal
# on equal inputs, but the float layers between them round some bf16 values
# the other way on the two devices, and such an input can quantise one step
# away (the CPU tests' bound for XLA vs the port, tests/test_torch_quantized_generic.py)
INT8G_MAPS_RTOL = 0.05


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up run)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_timed(torch, kernel, plain, reps: int, library=None):
    """(kernel_ms, plain_ms, library_ms or None), timed in turns: [library,]
    plain, kernel, kernel, plain[, library]."""
    l1 = time_ms(torch, library, reps) if library else None
    p1 = time_ms(torch, plain, reps)
    k1 = time_ms(torch, kernel, reps)
    k2 = time_ms(torch, kernel, reps)
    p2 = time_ms(torch, plain, reps)
    l_ms = (l1 + time_ms(torch, library, reps)) / 2 if library else None
    return (k1 + k2) / 2, (p1 + p2) / 2, l_ms


def took(counter: dict, fn):
    """(fn(), the kernels it ran by a wrapper's by-kernel counter, each name
    as often as it ran, joined by +)."""
    before = dict(counter)
    out = fn()
    names = [k for k in counter for _ in range(counter[k] - before[k])]
    return out, "+".join(names)


def decoder_kernels(convs: str, up2: str) -> str:
    """The decoder's four launches in order, from the names its two by-kernel
    counters gave (``took``: each sorted by name, so a mixed pair reads
    "fma+mma" whichever layer took which)."""
    return f"up2({up2})+conv({convs})"


def zero_conv_counters(hc, hd) -> None:
    """Set the encoder-stage and decoder kernels' launch counters to 0."""
    hc.fused_encoder_stage.launches = 0
    hd.fused_decoder.launches = 0
    hc.fused_encoder_stage.convs_by_kernel = dict.fromkeys(hc.CONV_KERNEL_CODES, 0)
    hd.fused_decoder.convs_by_kernel = dict.fromkeys(hd.fused_decoder.convs_by_kernel, 0)
    hd.fused_decoder.up2_by_kernel = dict.fromkeys(hd.UP2_KERNEL_CODES, 0)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: float, kind: str, moved: int) -> tuple[float, str]:
    """(bound_ms, bound_by): the least milliseconds the card could take for
    ``ops`` operations of type ``kind`` and ``moved`` bytes."""
    t_ops, t_bytes = ops / PEAK_OPS[kind], moved / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def stage_ops(b: int, h: int, w: int, cin: int, cout: int) -> float:
    """Multiply-adds x 2 of one encoder stage's three 3x3 convs."""
    return 2.0 * 9 * b * h * w * (cin * cout + 2 * cout * cout)


@functools.cache
def _made_train_arrays() -> dict:
    from pose_estimation_amitai_torch.data import make_synthetic_arrays

    return make_synthetic_arrays(num_frames=TRAIN_FRAMES, num_points=TRAIN_POINTS,
                                 image_size=192, seed=SEED)


def train_arrays() -> dict:
    """The training phases' contract arrays (16 synthetic 192x192 frames,
    32 wing points, seed 0): made once, and a fresh copy a call, which the
    caller may change."""
    return {k: v.copy() for k, v in _made_train_arrays().items()}


def repeat_train(torch, device_name: str, smi: str, runs: int) -> int:
    """The train phase ``runs`` times after the phases before it: one JSON
    line a run, the shared arrays (``train_arrays()``) and freshly made
    ones in turns; 1 if any run failed."""
    global train_arrays
    shared, failed = train_arrays, 0
    for i in range(runs):
        source = "fresh" if i % 2 else "shared"
        train_arrays = _made_train_arrays.__wrapped__ if i % 2 else shared
        t0 = time.perf_counter()
        try:
            phase_train(torch, device_name, smi)
            error = None
        except AssertionError as e:
            error, failed = str(e), failed + 1
        emit({"repeat_train": i, "arrays": source, "ok": error is None, "error": error,
              "seconds": time.perf_counter() - t0})
    train_arrays = shared
    return 1 if failed else 0


def phase_device(torch) -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"needs a Hopper card (capability 9.0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "capability": list(cap), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return name, smi


def ptxas_by_function(log: str) -> dict:
    """{kernel: {"registers": n, "spill_stores": b, "spill_loads": b}} from
    a library's ``-Xptxas -v`` output, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "bytes spill stores" in line:
            words = line.replace(",", "").split()
            out.setdefault(name, {})["spill_stores"] = int(words[words.index("spill") - 2])
            out[name]["spill_loads"] = int(words[-4])
        elif name and "Used" in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(line.split("Used")[1].split()[0])
    return out


def phase_build() -> dict:
    """Builds the kernels; returns, for the two libraries of the conv
    kernels, each kernel's registers and spills and the counts of the
    `wgmma` (HGMMA), TMA load (UTMALDG) and `mma.sync` (HMMA) instructions
    in their SASS."""
    from pose_estimation_amitai_torch.ops import _build

    t0 = time.perf_counter()
    out_dir = _build.build()
    seconds = time.perf_counter() - t0
    regs = {}
    for log in sorted(out_dir.glob("lib*.log")):
        regs[log.stem[3:]] = [
            line.split(":", 1)[1].strip() for line in log.read_text().splitlines()
            if "registers" in line
        ]
    conv_libs = {}
    for lib in ("encoder_stage", "decoder"):
        sass = subprocess.run(
            [os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump"), "-sass",
             str(out_dir / f"lib{lib}.so")],
            capture_output=True, text=True, check=True, timeout=300).stdout
        kernels = ptxas_by_function((out_dir / f"lib{lib}.log").read_text())
        conv_libs[lib] = {
            "sass": {op: sum(line.split()[1:2] == [op] or f" {op}." in line
                             or f" {op} " in line for line in sass.splitlines())
                     for op in ("HGMMA", "UTMALDG", "HMMA")},
            "ptxas": {k: v for k, v in kernels.items() if "conv3x3" in k},
        }
        check(conv_libs[lib]["sass"]["HGMMA"] > 0 and conv_libs[lib]["sass"]["UTMALDG"] > 0,
              f"lib{lib}.so: no wgmma or TMA load in its SASS")
        for kernel, (stores, loads) in WGMMA_SPILL_BUDGET.items():
            got = [v for k, v in kernels.items() if kernel in k]
            check(len(got) == 1 and got[0]["spill_stores"] <= stores
                  and got[0]["spill_loads"] <= loads,
                  f"lib{lib}.so: {kernel} spills {got}, budget {stores} / {loads} bytes")
    emit({"phase": "build", "seconds": seconds,
          "dir": str(out_dir.relative_to(_build.BUILD_ROOT.parents[1])),
          "ptxas": regs, "conv_libs": conv_libs})
    return conv_libs


def phase_kernels(torch, params, conv_libs: dict) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes;
    ``conv_libs``, phase_build's registers, spills and SASS counts of the
    conv kernels' libraries, go on the B1 and B2 rows."""
    from pose_estimation_amitai_torch.models import quantized
    from pose_estimation_amitai_torch.models.fast_infer import kernel_params
    from pose_estimation_amitai_torch.ops import hopper_attention as ha
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq
    from pose_estimation_amitai_torch.ops.int8_conv import max_pool_2x2

    # the shared-memory figures of the dispatch rules are the libraries' own
    check(hc.conv_c4_smem_bytes() == hc.conv_c4_smem_bytes_built(),
          "packed conv shared memory")
    check(ha.attention_mma_smem_bytes(VIT_TOKENS, VIT_DIM_HEAD)
          == ha.attention_mma_smem_bytes_built(VIT_TOKENS, VIT_DIM_HEAD),
          "attention shared memory at the served shape")
    check(hd.up2_mma_smem_bytes() == hd.up2_mma_smem_bytes_built(),
          "stride-2 layer shared memory")
    for dil in (1, 2, hc.MAX_DILATION):
        check(hq.qconv_mma_smem_bytes(dil) == hq.qconv_mma_smem_bytes_built(dil),
              f"int8 conv shared memory at dilation {dil}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    frames = torch.rand((CHUNK, 192, 192, 4), generator=gen, device="cuda")
    cases = {"fused_encoder_stage": [], "fused_decoder": [],
             "fused_quantized_stage": [], "quantized_conv3x3": [],
             "fused_attention": []}
    for dt in (torch.float32, torch.bfloat16):
        kp = kernel_params(params, dt, "cuda")
        x = frames.to(dt)
        for k, st in enumerate(kp["stages"]):
            args = (x, st["w1"], st["b1"], st["w2"], st["b2"], st["w3"], st["b3"])
            kw = dict(dilation=2, alpha=0.1, pool=k < 2)
            got, ran = took(hc.fused_encoder_stage.convs_by_kernel,
                            lambda: hc.fused_encoder_stage(*args, **kw))
            want = hc.fused_encoder_stage_plain(*args, **kw)
            expect = "fma+fma+fma" if dt == torch.float32 else (
                "mma_c4+wgmma+wgmma" if k == 0 else "wgmma+wgmma+wgmma")
            check(ran == expect, f"stage {k} {dt}: kernels {ran}, expected {expect}")
            cases["fused_encoder_stage"].append(_case(
                torch, f"{tuple(x.shape)}->{tuple(want.shape)}", dt, got, want,
                lambda: hc.fused_encoder_stage(*args, **kw),
                lambda: hc.fused_encoder_stage_plain(*args, **kw),
                bound(stage_ops(*x.shape, st["w1"].shape[-1]), "bf16",
                      nbytes(*args, want)),
            ))
            cases["fused_encoder_stage"][-1]["kernel"] = ran
            if dt == torch.bfloat16:
                cases["fused_encoder_stage"][-1].update(
                    fma_ms=time_ms(torch, lambda: hc.fused_encoder_stage_on(
                        ("fma",) * 3, *args, **kw), PREVIOUS_REPS),
                    **rounding_flips(torch, got, want, args, kw))
            x = want  # the next stage's input: this stage's plain output
        d = kp["decoder"]
        (got, ran), up2 = took(hd.fused_decoder.up2_by_kernel, lambda: took(
            hd.fused_decoder.convs_by_kernel, lambda: hd.fused_decoder(x, **d)))
        want = hd.fused_decoder_plain(x, **d)
        expect = "fma+fma" if dt == torch.float32 else "mma+mma"
        check(ran == expect.replace("mma", "wgmma") and up2 == expect,
              f"decoder {dt}: stride-1 convs on {ran}, stride-2 layers on {up2}")
        pix = x.shape[0] * x.shape[1] * x.shape[2]
        mid, k = d["w1"].shape[-1], d["w4"].shape[-1]
        # real multiply-adds: a stride-2 transposed conv does 9 per input pixel
        ops = 2.0 * 9 * pix * (x.shape[3] * mid + 2 * 4 * mid * mid + 4 * mid * k)
        cases["fused_decoder"].append(_case(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", dt, got, want,
            lambda: hd.fused_decoder(x, **d), lambda: hd.fused_decoder_plain(x, **d),
            bound(ops, "bf16", nbytes(x, *d.values(), want)),
        ))
        cases["fused_decoder"][-1]["kernel"] = decoder_kernels(ran, up2)
        if dt == torch.bfloat16:
            # the CUDA-core kernels on the same tensors
            cases["fused_decoder"][-1]["fma_ms"] = time_ms(
                torch, lambda: hd.fused_decoder_on("fma", ("fma", "fma"), x, **d),
                PREVIOUS_REPS)
        del got, want

    # a general shape on the CUDA-core conv kernel in bf16 (channel counts off
    # the tensor-core tiles), held against plain like the served ones
    x = torch.rand((2, 40, 52, 9), generator=gen, device="cuda").to(torch.bfloat16)
    args = [x]
    for c in (9, 70, 70):
        args += [(torch.randn((3, 3, c, 70), generator=gen, device="cuda")
                  * (9 * c) ** -0.5).to(torch.bfloat16),
                 torch.randn((70,), generator=gen, device="cuda") * 0.05]
    got, ran = took(hc.fused_encoder_stage.convs_by_kernel,
                    lambda: hc.fused_encoder_stage(*args, dilation=2, pool=True))
    want = hc.fused_encoder_stage_plain(*args, dilation=2, pool=True)
    check(ran == "fma+fma+fma", f"9 -> 70 channels took {ran}")
    general = {"fused_encoder_stage": [_case(
        torch, f"{tuple(x.shape)}->{tuple(want.shape)}", torch.bfloat16, got, want,
        lambda: hc.fused_encoder_stage(*args, dilation=2, pool=True),
        lambda: hc.fused_encoder_stage_plain(*args, dilation=2, pool=True),
        bound(stage_ops(*x.shape, 70), "bf16", nbytes(*args, want)))]}
    general["fused_encoder_stage"][0]["kernel"] = "fma+fma+fma"
    del got, want

    # the decoder in bf16 at ragged sizes: both stride-2 layers on the
    # tensor-core kernel (Cin a multiple of 16; K = 5 off every multiple the
    # stores like), a whole-row head of 24 channels beside a CUDA-core layer,
    # and both layers on the CUDA-core kernel (cin 9)
    general["fused_decoder"] = []
    for cin, mid, k, expect in ((48, 32, 5, "mma+mma"), (48, 24, 5, "fma+mma"),
                                (9, 24, 5, "fma+fma")):
        x = torch.rand((2, 13, 10, cin), generator=gen, device="cuda").to(torch.bfloat16)
        args = [x]
        for ci, co in ((cin, mid), (mid, mid), (mid, mid), (mid, k)):
            args += [(torch.randn((3, 3, ci, co), generator=gen, device="cuda")
                      * (9 * ci) ** -0.5).to(torch.bfloat16),
                     torch.randn((co,), generator=gen, device="cuda") * 0.05]
        (got, ran), up2 = took(hd.fused_decoder.up2_by_kernel, lambda: took(
            hd.fused_decoder.convs_by_kernel, lambda: hd.fused_decoder(*args)))
        want = hd.fused_decoder_plain(*args)
        check(up2 == expect, f"decoder {cin} -> {mid} -> {k}: stride-2 layers on {up2}")
        pix = x.shape[0] * x.shape[1] * x.shape[2]
        general["fused_decoder"].append(_case(
            torch, f"{tuple(x.shape)}->{mid}->{tuple(want.shape)}", torch.bfloat16,
            got, want, lambda: hd.fused_decoder(*args),
            lambda: hd.fused_decoder_plain(*args),
            bound(2.0 * 9 * pix * (cin * mid + 8 * mid * mid + 4 * mid * k), "bf16",
                  nbytes(*args, want))))
        general["fused_decoder"][-1]["kernel"] = decoder_kernels(ran, up2)
        del got, want

    # the int8 stage at its three flagship shapes: scales calibrated on the
    # first frames, each stage fed the pooled plain output of the one before
    scales = quantized.calibrate(params, frames[:CALIB_FRAMES].cpu().numpy(),
                                 device="cuda")
    layers, s_x = quantized.device_layers(params, scales, "cuda")
    inv = {n: 1.0 / v for n, v in s_x.items()}
    x = hq.quant_bf16(frames, inv["conv1"]).contiguous()
    for s in range(3):
        args = (x, *quantized.stage_args(layers, s))
        nxt = f"conv{3 * s + 4}" if s < 2 else "deconv1"
        kw = dict(inv_s2=inv[f"conv{3 * s + 2}"], inv_s3=inv[f"conv{3 * s + 3}"],
                  inv_out=inv[nxt], dilation=2, alpha=0.1, pool=s < 2)
        got, ran = took(hq.fused_quantized_stage.convs_by_kernel,
                        lambda: hq.fused_quantized_stage(*args, **kw))
        want = hq.fused_quantized_stage_plain(*args, **kw)
        expect = "mma_s8+mma_s8+mma_s8_c4" if s == 0 else "mma_s8+mma_s8+mma_s8"
        check(ran == expect, f"int8 stage {s}: kernels {ran}, expected {expect}")
        for n in (f"conv{3 * s + i}" for i in (1, 2, 3)):  # packed once, by the kernel
            check(bool(torch.equal(layers[n]["w_packed"],
                                   hq.pack_qconv_weights_plain(layers[n]["w_q"]))),
                  f"{n}: packed weights differ from the plain packing")
        # the operands as the JAX function takes them (HWIO int8 weights)
        operands = [x] + [t for n in (f"conv{3 * s + i}" for i in (1, 2, 3))
                          for t in (layers[n]["w_q"], layers[n]["mult"], layers[n]["bias"])]
        cases["fused_quantized_stage"].append(_case_int8(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", got, want,
            lambda: hq.fused_quantized_stage(*args, **kw),
            lambda: hq.fused_quantized_stage_plain(*args, **kw),
            bound(stage_ops(*x.shape, want.shape[-1]), "int8", nbytes(*operands, want)),
        ))
        cases["fused_quantized_stage"][-1].update(
            kernel=ran, previous_ms=time_ms(
                torch, lambda: hq.fused_quantized_stage_on(("dp4a",) * 3, *args, **kw),
                PREVIOUS_REPS))
        x = max_pool_2x2(want).contiguous() if s < 2 else want
        del got, want

    # the int8 stage at ragged tiles (40 x 52 pixels, the last channel tile
    # half full), dilation 1 and 3, on the tensor-core kernel; at 32 -> 40
    # channels, where only the first conv takes it; at 4 -> 40 (the first
    # conv on the 4-channel tensor-core kernel); at 9 -> 70 on the CUDA-core
    # kernel
    general["fused_quantized_stage"] = []
    rng = np.random.default_rng(SEED)
    for cin, cout, dil, expect in ((32, 96, 1, "mma_s8+mma_s8+mma_s8"),
                                   (32, 96, 3, "mma_s8+mma_s8+mma_s8"),
                                   (32, 40, 3, "dp4a+dp4a+mma_s8"),
                                   (4, 40, 3, "dp4a+dp4a+mma_s8_c4"),
                                   (9, 70, 2, "dp4a+dp4a+dp4a")):
        args = [torch.from_numpy(rng.integers(-127, 128, (2, 40, 52, cin)).astype(np.int8))]
        for c in (cin, cout, cout):
            args += [torch.from_numpy(a) for a in (
                rng.integers(-127, 128, (3, 3, c, cout)).astype(np.int8),
                (rng.uniform(0.5, 1.5, cout) / (np.sqrt(9 * c) * 5329)).astype(np.float32),
                (rng.standard_normal(cout) * 0.05).astype(np.float32))]
        args = [a.to("cuda") for a in args]
        kw = dict(inv_s2=30.0, inv_s3=25.0, inv_out=35.0, dilation=dil, pool=dil != 1)
        got, ran = took(hq.fused_quantized_stage.convs_by_kernel,
                        lambda: hq.fused_quantized_stage(*args, **kw))
        want = hq.fused_quantized_stage_plain(*args, **kw)
        check(ran == expect, f"int8 stage {cin} -> {cout}: kernels {ran}, expected {expect}")
        general["fused_quantized_stage"].append(_case_int8(
            torch, f"(2, 40, 52, {cin})->{cout} dilation {dil}", got, want,
            lambda: hq.fused_quantized_stage(*args, **kw),
            lambda: hq.fused_quantized_stage_plain(*args, **kw),
            bound(stage_ops(2, 40, 52, cin, cout), "int8", nbytes(*args, want))))
        general["fused_quantized_stage"][-1]["kernel"] = ran
        del got, want

    # the single int8 conv on the experiment's seeded inputs, batch 8 and 256
    for b in (IM2COL_BATCH, CHUNK):
        x, w, mult, bias = im2col_inputs(torch, b)
        got, ran = took(hq.quantized_conv3x3.launches_by_kernel,
                        lambda: hq.quantized_conv3x3(x, w, mult, bias))
        want = hq.quantized_conv3x3_plain(x, w, mult, bias)
        check(ran == "mma_s8", f"the single int8 conv took {ran}")
        cases["quantized_conv3x3"].append(_case_int8(
            torch, f"{tuple(x.shape)}->{tuple(want.shape)}", got, want,
            lambda: hq.quantized_conv3x3(x, w, mult, bias),
            lambda: hq.quantized_conv3x3_plain(x, w, mult, bias),
            bound(2.0 * 9 * x.numel() * w.shape[-1], "int8",
                  nbytes(x, w, mult, bias, want)),
        ))
        cases["quantized_conv3x3"][-1].update(
            kernel=ran, previous_ms=time_ms(
                torch, lambda: hq.quantized_conv3x3_on("dp4a", x, w, mult, bias),
                PREVIOUS_REPS))
        del got, want

    # the attention kernel on the ViT's own views: q, k, v sliced from one
    # (B, N, 3, H, D) tensor, the result written through a permuted view;
    # the encoder's 8 heads in float32 and bf16, the fusion block's 4 in bf16
    import torch.nn.functional as F

    for dt, heads in ((torch.float32, 8), (torch.bfloat16, 8), (torch.bfloat16, 4)):
        qkv = torch.randn((CHUNK, VIT_TOKENS, 3, heads, VIT_DIM_HEAD), generator=gen,
                          device="cuda").to(dt)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # (B, H, N, D)
        out = torch.empty((CHUNK, VIT_TOKENS, heads, VIT_DIM_HEAD), dtype=dt,
                          device="cuda")
        got, ran = took(ha.fused_attention.launches_by_kernel,
                        lambda: ha.fused_attention(q, k, v, out=out.permute(0, 2, 1, 3)))
        want = ha.fused_attention_plain(q, k, v)
        check(ran == ("fma" if dt == torch.float32 else "mma"),
              f"attention {dt} heads {heads}: kernel {ran}")
        g = CHUNK * heads
        cases["fused_attention"].append(_case(
            torch, f"{tuple(q.shape)} heads {heads}", dt, got, want,
            lambda: ha.fused_attention(q, k, v, out=out.permute(0, 2, 1, 3)),
            lambda: ha.fused_attention_plain(q, k, v),
            bound(4.0 * g * VIT_TOKENS ** 2 * VIT_DIM_HEAD,
                  "f32" if dt == torch.float32 else "bf16", nbytes(q, k, v, want)),
            library_fn=lambda: F.scaled_dot_product_attention(q, k, v),
        ))
        lib = F.scaled_dot_product_attention(q, k, v)
        cases["fused_attention"][-1]["library_max_abs_err"] = (
            lib.float() - want.float()).abs().max().item()
        cases["fused_attention"][-1]["kernel"] = ran
        if dt == torch.bfloat16:
            cases["fused_attention"][-1]["previous_ms"] = time_ms(
                torch, lambda: ha.fused_attention_on(
                    "fma", q, k, v, out=out.permute(0, 2, 1, 3)), 5)
        del qkv, out, got, want, lib

    # a general shape on the CUDA-core attention kernel in bf16 (N off the
    # 16-row tiles, D off the multiples of 16)
    q, k, v = (torch.randn((5, 100, 72), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    got, ran = took(ha.fused_attention.launches_by_kernel,
                    lambda: ha.fused_attention(q, k, v))
    want = ha.fused_attention_plain(q, k, v)
    check(ran == "fma", f"attention (5, 100, 72) took {ran}")
    general["fused_attention"] = [_case(
        torch, "(5, 100, 72)", torch.bfloat16, got, want,
        lambda: ha.fused_attention(q, k, v),
        lambda: ha.fused_attention_plain(q, k, v),
        bound(4.0 * 5 * 100 ** 2 * 72, "bf16", nbytes(q, k, v, want)),
        library_fn=lambda: F.scaled_dot_product_attention(q, k, v))]
    general["fused_attention"][0]["kernel"] = "fma"
    del got, want

    csrc = "pose_estimation_amitai_torch/csrc/"
    tpu = "pose_estimation_amitai_tpu/ops/"
    rows = []
    for name, source, replaces in (
        ("fused_encoder_stage", csrc + "encoder_stage.cu", tpu + "pallas_conv.py:245"),
        ("fused_decoder", csrc + "decoder.cu", tpu + "pallas_deconv.py:190"),
        ("fused_quantized_stage", csrc + "qconv_stage.cu", tpu + "pallas_qconv.py:227"),
        ("quantized_conv3x3", csrc + "qconv_stage.cu", "scripts/exp_im2col_pallas.py:100"),
        ("fused_attention", csrc + "attention.cu", "scripts/exp_fused_attention.py:63"),
    ):
        cs = cases[name]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": 0}  # set from the run of the path that drives it
        library_ms = None  # no single PyTorch call computes it
        if name == "fused_attention":
            served = cs[1:2]  # one launch of the encoder's, bf16, as served
            library_ms = served[0]["library_ms"]
            row.update(
                max_abs_err=cs[0]["max_abs_err"],
                max_abs_err_bf16=max(c["max_abs_err"] for c in cs[1:]),
                tolerance={"float32_atol": F32_ATOL, "bf16_rtol_of_max": BF16_RTOL})
        elif name == "quantized_conv3x3":
            served = cs[-1:]  # batch 256; batch 8 is in the cases
            row.update(max_abs_err=max(c["max_abs_err"] for c in cs),
                       tolerance="int8 outputs equal")
        elif name == "fused_quantized_stage":
            served = cs
            row.update(max_abs_err=max(c["max_abs_err"] for c in cs),
                       tolerance="int8 outputs equal")
        else:
            served = [c for c in cs if c["dtype"] == "bfloat16"]  # the served dtype
            row.update(
                max_abs_err=max(c["max_abs_err"] for c in cs if c["dtype"] == "float32"),
                max_abs_err_bf16=max(c["max_abs_err"] for c in served),
                tolerance={"float32_atol": F32_ATOL, "bf16_rtol_of_max": BF16_RTOL})
        # summed over one chunk's calls
        row.update(ms=sum(c["ms"] for c in served),
                   plain_ms=sum(c["plain_ms"] for c in served),
                   bound_ms=sum(c["bound_ms"] for c in served),
                   bound_by=max(served, key=lambda c: c["bound_ms"])["bound_by"],
                   library_ms=library_ms, cases=cs)
        if "previous_ms" in served[0]:
            row.update(previous_ms=sum(c["previous_ms"] for c in served),
                       kernel=[c["kernel"] for c in served])
        if "fma_ms" in served[0]:  # B1 and B2: the wgmma conv kernel's rows
            row.update(fma_ms=sum(c["fma_ms"] for c in served),
                       kernel=[c["kernel"] for c in served],
                       stage_ms=[c["ms"] for c in served],
                       stage_bound_ms=[c["bound_ms"] for c in served],
                       conv_lib=conv_libs[source.rsplit("/", 1)[1][:-3]])
        if name in general:
            row["general_cases"] = general[name]
        rows.append(row)
    folded = folded_cases(torch, kernel_params(params, torch.bfloat16, "cuda"))
    emit({"phase": "kernels", "batch": CHUNK, "tf32": False,
          "cases": {r["name"]: r["cases"] for r in rows}, "general_cases": general,
          "folded_rows": FOLDED_VIEWS * CHUNK, "folded_cases": folded})
    return rows


def ftl_fusion_row(torch) -> dict:
    """The ``ftl_fusion`` row at ftl.movie's shapes (FTL_SAMPLES samples of
    FTL_LATENT, seeded bf16 operands): the kernel against the plain version
    (within FTL_RTOL of its largest value), the kernel's time, the plain
    version's, the "gemm" composition's (the path it replaces, as
    ``previous_ms``) timed in turns beside it, the bound, and the kernel's
    registers and spills (within FTL_SPILL_BUDGET). ``launches`` is set from
    the zoo phase's fused camera model."""
    from pose_estimation_amitai_torch.ops import _build
    from pose_estimation_amitai_torch.ops import ftl_fusion as ff
    from pose_estimation_amitai_torch.ops import hopper_ftl

    b, (h, w, c) = FTL_SAMPLES, FTL_LATENT
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    P = rand(b, 4, 3, 4)
    P = P / P.norm(dim=(-2, -1), keepdim=True)
    P_inv = torch.linalg.pinv(P.double()).float()
    P_inv = (P_inv / P_inv.norm(dim=(-2, -1), keepdim=True)).contiguous()
    args = [rand(4 * b, h, w, c, scale=0.5).to(torch.bfloat16), P, P_inv]
    for cin, cout in ((c, 300), (1600, 400), (400, 400), (300, c)):
        args += [rand(cin, cout, scale=cin ** -0.5).to(torch.bfloat16),
                 rand(cout, scale=0.05).to(torch.bfloat16)]
    for n in (400, 400, 300):
        args.append(torch.stack([1 + rand(n, scale=0.1), rand(n, scale=0.1),
                                 rand(n, scale=0.3), (1 + rand(n, scale=0.1)).abs()]))
    args.append(1e-5)
    check(ff.ftl_path_for(args[0].device, torch.bfloat16, c, 300) == "wgmma",
          "ftl.movie's shapes do not take the ftl_fusion kernel")
    before = hopper_ftl.ftl_fusion_kernel.launches
    got = ff.ftl_fusion(*args)
    torch.cuda.synchronize()
    check(hopper_ftl.ftl_fusion_kernel.launches == before + 1, "ftl_fusion: no kernel launch")
    want = ff.ftl_fusion_plain(*args).float()
    scale = float(want.abs().max())
    err = float((got.float() - want).abs().max())
    check(err <= FTL_RTOL * scale, f"ftl_fusion kernel {err} from plain, max {scale}")
    del got, want
    kernel_ms, plain_ms, _ = compare_timed(
        torch, lambda: hopper_ftl.ftl_fusion_kernel(*args),
        lambda: ff.ftl_fusion_plain(*args), 3)
    gemm_ms = (time_ms(torch, lambda: ff.ftl_fusion_gemm(*args), 3)
               + time_ms(torch, lambda: ff.ftl_fusion_gemm(*args), 3)) / 2
    pix = h * w
    ops = b * (2.0 * pix * (4 * c * 300 + 1600 * 400 + 400 * 400 + 4 * 300 * c)
               + 2 * 4 * 2.0 * pix * 100 * 12)
    weights = 2 * (c * 300 + 1600 * 400 + 400 * 400 + 300 * c + 300 + 400 + 400 + c)
    moved = 3 * 4 * b * pix * c * 2 + weights + 4 * 4 * 1100 + b * 4 * 2 * 12 * 4
    bound_ms = max(ops / PEAK_OPS["bf16"], moved / PEAK_BYTES) * 1e3
    log = (_build.build() / "libftl_fusion.log").read_text()
    ptxas = {k: v for k, v in ptxas_by_function(log).items() if "ftl_fusion_kernel" in k}
    stores, loads = FTL_SPILL_BUDGET
    check(len(ptxas) == 3 and all(v["spill_stores"] <= stores and v["spill_loads"] <= loads
                                  for v in ptxas.values()),
          f"ftl_fusion_kernel spills {ptxas}, budget {stores} / {loads} bytes")
    return {"name": "ftl_fusion", "route": "cuda", "source": "csrc/ftl_fusion.cu",
            "replaces": "none: pose_estimation_amitai_tpu/models/disentangled.py runs it in XLA",
            "launches": 0, "kernel": "wgmma", "samples": b, "view_rows": 4 * b,
            "max_abs_err_bf16": err, "tolerance": {"bf16_rtol_of_max": FTL_RTOL},
            "ms": kernel_ms, "plain_ms": plain_ms, "previous_ms": gemm_ms,
            "previous": "gemm", "bound_ms": bound_ms,
            "bound_by": "ops" if ops / PEAK_OPS["bf16"] >= moved / PEAK_BYTES else "bytes",
            "library_ms": None, "ptxas": ptxas}


def folded_cases(torch, kp: dict) -> dict:
    """B1's three stages and B2 in bf16 at FOLDED_VIEWS x CHUNK rows, the
    batch of a 4-camera chunk with its views folded in (stage 1's x1 and x2
    then hold 2.4e9 elements, past 2^31), each on the kernels the CHUNK-row
    cases take and within BF16_RTOL of the plain version's largest value.
    The plain version runs CHUNK rows at a time (its rows are independent);
    each such slice's error is reported, so a fault in the upper rows shows
    by where it lies. Each stage takes the plain output of the one before."""
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd

    rows = FOLDED_VIEWS * CHUNK
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.rand((rows, 192, 192, 4), generator=gen, device="cuda").to(torch.bfloat16)

    def case(run, plain, expect: str, kernel_fn) -> tuple[dict, object]:
        """(the case's numbers, the plain output of all rows)."""
        got, ran = run()
        torch.cuda.synchronize()
        check(ran == expect, f"{rows} rows: kernels {ran}, expected {expect}")
        check(bool(torch.isfinite(got.float()).all()), f"{rows} rows: non-finite output")
        parts, errs, scale = [], [], 0.0
        for i in range(0, rows, CHUNK):
            want = plain(slice(i, i + CHUNK))
            check(want.shape[1:] == got.shape[1:] and want.dtype == got.dtype,
                  f"{rows} rows: kernel gave {tuple(got.shape)} {got.dtype}")
            errs.append((got[i : i + CHUNK].float() - want.float()).abs().max().item())
            scale = max(scale, want.float().abs().max().item())
            parts.append(want)
        err = max(errs)
        shape = f"{tuple(x.shape)}->{tuple(got.shape)}"
        check(err <= BF16_RTOL * scale, f"{shape} bf16: max err {err} > {BF16_RTOL} * {scale}"
              f" (by {CHUNK} rows: {errs})")
        del got
        return {"shape": shape, "dtype": "bfloat16", "kernel": ran, "max_abs_err": err,
                f"max_abs_err_by_{CHUNK}_rows": errs, "max_abs_plain": scale,
                "ms": time_ms(torch, kernel_fn, 3)}, torch.cat(parts)

    out = {"fused_encoder_stage": [], "fused_decoder": []}
    for k, st in enumerate(kp["stages"]):
        w = tuple(st[n] for n in ("w1", "b1", "w2", "b2", "w3", "b3"))
        kw = dict(dilation=2, alpha=0.1, pool=k < 2)
        row, nxt = case(
            lambda: took(hc.fused_encoder_stage.convs_by_kernel,
                         lambda: hc.fused_encoder_stage(x, *w, **kw)),
            lambda s: hc.fused_encoder_stage_plain(x[s], *w, **kw),
            "mma_c4+wgmma+wgmma" if k == 0 else "wgmma+wgmma+wgmma",
            lambda: hc.fused_encoder_stage(x, *w, **kw))
        out["fused_encoder_stage"].append(row)
        x = nxt
    d = kp["decoder"]

    def decoder_run():
        (got, ran), up2 = took(hd.fused_decoder.up2_by_kernel, lambda: took(
            hd.fused_decoder.convs_by_kernel, lambda: hd.fused_decoder(x, **d)))
        return got, decoder_kernels(ran, up2)

    row, _ = case(decoder_run, lambda s: hd.fused_decoder_plain(x[s], **d),
                  decoder_kernels("wgmma+wgmma", "mma+mma"), lambda: hd.fused_decoder(x, **d))
    out["fused_decoder"].append(row)
    return out


IM2COL_BATCH = 8  # the experiment's batch
VIT_TOKENS = 144  # (192 / 16) ** 2
VIT_DIM_HEAD = 256  # Config(): dim_head = projection_dim


def im2col_inputs(torch, batch: int):
    """x, w, mult, bias of scripts/exp_im2col_pallas.py's main (192 x 192 x
    64 -> 64, its value ranges, seed 0), on the card."""
    rng = np.random.default_rng(0)
    w = rng.integers(-90, 90, (3, 3, 64, 64)).astype(np.int8)
    mult = rng.uniform(5e-4, 2e-3, (64,)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, (64,)).astype(np.float32)
    x = rng.integers(-80, 80, (batch, 192, 192, 64)).astype(np.int8)
    return tuple(torch.from_numpy(a).to("cuda") for a in (x, w, mult, bias))


def _case_int8(torch, shape, got, want, kernel_fn, plain_fn, bnd) -> dict:
    """An int8 kernel must equal its plain version, every element."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype == torch.int8,
          f"{shape}: kernel gave {tuple(got.shape)} {got.dtype}")
    differ = int((got != want).sum())
    err = (got.int() - want.int()).abs().max().item()
    check(differ == 0, f"{shape} int8: {differ} outputs differ, by up to {err}")
    mean = want.float().abs().mean().item()
    check(mean > 4, f"{shape} int8: plain outputs average {mean}: range unused")
    k_ms, p_ms, _ = compare_timed(torch, kernel_fn, plain_fn, reps=3)
    return {"shape": shape, "dtype": "int8", "max_abs_err": err,
            "mean_abs_plain": mean, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1]}


def _case(torch, shape, dt, got, want, kernel_fn, plain_fn, bnd, library_fn=None) -> dict:
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{shape}: kernel gave {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{shape}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dt == torch.float32:
        check(err <= F32_ATOL, f"{shape} float32: max err {err} > {F32_ATOL}")
    else:
        check(err <= BF16_RTOL * scale,
              f"{shape} bf16: max err {err} > {BF16_RTOL} * {scale}")
    k_ms, p_ms, l_ms = compare_timed(torch, kernel_fn, plain_fn, 5, library_fn)
    return {"shape": shape, "dtype": str(dt).removeprefix("torch."),
            "max_abs_err": err, "max_abs_plain": scale, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": l_ms}


def rounding_flips(torch, got, want, args, kw) -> dict:
    """Where a bf16 stage's distance from its plain version comes from.
    The kernel takes each conv's f32 sum in another order than the plain
    version, so an x1 or x2 that lies near a rounding boundary lands one bf16
    step to the other side and the next conv carries the step on. Shown by
    the plain version itself with every conv's sum taken in two halves of
    the input channels, which no kernel touches: its distance from the plain
    version beside the kernel's, each as the largest error, the share of
    outputs that differ at all and the share beyond half the limit."""
    import torch.nn.functional as F

    from pose_estimation_amitai_torch.ops.hopper_conv import bias_nchw, lrelu

    half_limit = 0.5 * BF16_RTOL * want.float().abs().max().item()

    def distance(a, b):
        d = (a.float() - b.float()).abs()
        return {"max_abs_err": d.max().item(),
                "share_differing": (d > 0).float().mean().item(),
                "share_over_half_the_limit": (d > half_limit).float().mean().item()}

    x, w1, b1, w2, b2, w3, b3 = args
    dil, alpha, dt = kw["dilation"], kw["alpha"], x.dtype

    def conv(h, w):
        wt, half = w.float().permute(3, 2, 0, 1), h.shape[1] // 2
        return (F.conv2d(h[:, :half], wt[:, :half], padding=dil, dilation=dil)
                + F.conv2d(h[:, half:], wt[:, half:], padding=dil, dilation=dil))

    h = x.permute(0, 3, 1, 2).float()
    x1 = lrelu(conv(h, w1) + bias_nchw(b1), alpha).to(dt).float()
    x2 = (lrelu(conv(x1, w2) + bias_nchw(b2), alpha) + x1).to(dt).float()
    y = lrelu(conv(x2, w3) + bias_nchw(b3), alpha) + x2
    del h, x1
    if kw["pool"]:
        y = lrelu(F.max_pool2d(y, 2, 2, ceil_mode=True), alpha)
    halves = y.to(dt).permute(0, 2, 3, 1)
    return {"kernel_vs_plain": distance(got, want),
            "plain_in_halves_vs_plain": distance(halves, want)}


def serve(pred, frames) -> tuple[list, np.ndarray, float, float]:
    """The requests one by one, then the whole as a movie: (answers, movie
    peaks, seconds of the requests, seconds of the movie)."""
    t0 = time.perf_counter()
    answers, i = [], 0
    for r in REQUESTS:
        answers.append(pred(frames[i : i + r]))
        i += r
    t_req = time.perf_counter() - t0
    t0 = time.perf_counter()
    movie = pred.predict_movie(frames)
    return answers, movie, t_req, time.perf_counter() - t0


def check_peaks(answers, movie, n: int, k: int) -> np.ndarray:
    peaks = np.concatenate(answers)
    check(peaks.shape == (n, 3, k) and movie.shape == (n, 3, k),
          f"peak shapes {peaks.shape} {movie.shape}")
    check(bool(np.isfinite(peaks).all()), "non-finite peaks")
    check(bool(((peaks[:, 0] >= 0) & (peaks[:, 0] <= 191)
                & (peaks[:, 1] >= 0) & (peaks[:, 1] <= 191)).all()),
          "peaks outside the frame")
    check(np.array_equal(peaks, movie), "predict_movie disagrees with the requests")
    return peaks


def movie_frames(frames: np.ndarray) -> np.ndarray:
    """MOVIE_CHUNKS chunks of distinct frames made cheaply from ``frames``:
    chunk j is the frames from index MOVIE_STRIDE * j on, wrapping, plus
    j / 64."""
    n = len(frames)
    out = np.empty((MOVIE_CHUNKS * CHUNK, *frames.shape[1:]), frames.dtype)
    for j in range(MOVIE_CHUNKS):
        idx = (np.arange(CHUNK) + MOVIE_STRIDE * j) % n
        np.add(frames[idx], np.float32(j / 64), out=out[j * CHUNK : (j + 1) * CHUNK])
    return out


def staging(torch, pred, movie: np.ndarray, counters, zero) -> dict:
    """The movie of distinct frames through ``pred.predict_movie`` at each
    of MOVIE_PREFETCH (host clock), its peaks bit-equal to each chunk served
    alone from a device-resident tensor, ``counters()`` read just after each
    movie and ``zero()`` called just before; and per chunk: the stager's
    host fill of a pinned buffer (host clock), its pinned H2D copy (CUDA
    events on its copy stream), the compute from a resident tensor (CUDA
    events)."""
    from pose_estimation_amitai_torch.infer import fill_pinned

    cs = pred.chunk_size
    chunks = [movie[i : i + cs] for i in range(0, len(movie), cs)]
    resident = [torch.from_numpy(c).to("cuda") for c in chunks]
    want = np.concatenate([pred(r) for r in resident])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in resident:
        pred._run(r)
    end.record()
    torch.cuda.synchronize()
    compute_ms = start.elapsed_time(end) / len(chunks)
    del resident

    st = pred._stager
    buf = st.buffers(torch.float32, movie.shape[1:])[0]
    t0 = time.perf_counter()
    for c in chunks:
        fill_pinned(buf, c)
    fill_ms = (time.perf_counter() - t0) * 1e3 / len(chunks)
    dev = torch.empty(buf.shape, dtype=buf.dtype, device="cuda")
    with torch.cuda.stream(st.stream):
        dev.copy_(buf, non_blocking=True)  # warm-up
        start.record(st.stream)
        for _ in chunks:
            dev.copy_(buf, non_blocking=True)
        end.record(st.stream)
    torch.cuda.synchronize()
    h2d_ms = start.elapsed_time(end) / len(chunks)
    del dev

    rates, launches = {}, {}
    for p in MOVIE_PREFETCH:
        zero()
        t0 = time.perf_counter()
        got = pred.predict_movie(movie, prefetch=p)
        t = time.perf_counter() - t0
        launches[p] = counters()
        check(np.array_equal(got, want),
              f"predict_movie at prefetch {p} differs from the chunks served one at a time")
        rates[p] = len(movie) / t
    return {"frames": len(movie), "chunk_size": cs, "movie_frames_per_s": rates,
            "host_fill_ms_per_chunk": fill_ms, "pinned_h2d_ms_per_chunk": h2d_ms,
            "h2d_gb_per_s": buf.numel() * buf.element_size() / h2d_ms * 1e-6,
            "resident_compute_ms_per_chunk": compute_ms, "launches": launches,
            "movie_launches": launches[MOVIE_PREFETCH[-1]]}


def phase_slice(torch, cfg, params, frames, movie, device_name: str, smi: str) -> dict:
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd

    n = sum(REQUESTS)
    k = 18

    def predictor(c, use_fused: bool, **kw):
        return Predictor(c, params, (192, 192, 4), k, device="cuda",
                         chunk_size=CHUNK, use_fused=use_fused, **kw)

    check(cfg.num_base_filters == 64 and cfg.compute_dtype == "bfloat16",
          "Config() default is filters 64, bf16")
    fused = predictor(cfg, True)
    check(fused.serving_path == "fused", f"serving_path {fused.serving_path}")
    fused(frames[:1])  # warm-up: allocator, library load

    # ---- the main path: counters zeroed just before, read just after ----
    zero_conv_counters(hc, hd)
    answers, movie_peaks, t_req, t_movie = serve(fused, frames)
    launches = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                "fused_decoder": hd.fused_decoder.launches}
    convs = dict(hc.fused_encoder_stage.convs_by_kernel)
    decoder_convs = dict(hd.fused_decoder.convs_by_kernel)
    decoder_up2 = dict(hd.fused_decoder.up2_by_kernel)
    # ---------------------------------------------------------------------
    chunks = sum(-(-r // CHUNK) for r in REQUESTS) + -(-n // CHUNK)
    check(convs == {"fma": 0, "mma_c4": chunks, "wgmma": 8 * chunks}
          and decoder_convs == {"fma": 0, "wgmma": 2 * chunks}
          and decoder_up2 == {"fma": 0, "mma": 2 * chunks},
          f"the served convs took {convs}, the decoder's {decoder_convs}, its "
          f"stride-2 layers {decoder_up2}: not all on the tensor cores")
    check(launches["fused_encoder_stage"] == 3 * chunks
          and launches["fused_decoder"] == chunks,
          f"launch counts {launches}, expected {3 * chunks} and {chunks}")
    check_peaks(answers, movie_peaks, n, k)

    # ---- the staging movie: counters zeroed just before, read just after ----
    staged = staging(
        torch, fused, movie,
        lambda: {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                 "fused_decoder": hd.fused_decoder.launches},
        lambda: zero_conv_counters(hc, hd))
    for p, got in staged["launches"].items():
        check(got == {"fused_encoder_stage": 3 * MOVIE_CHUNKS, "fused_decoder": MOVIE_CHUNKS},
              f"the movie at prefetch {p} launched {got}")

    module = predictor(cfg, False)
    check(module.serving_path == "module", module.serving_path)
    module(frames[:1])
    t0 = time.perf_counter()
    j = 0
    for r in REQUESTS:
        module(frames[j : j + r])
        j += r
    t_mod = time.perf_counter() - t0

    # the first request's maps and peaks, fused vs module, at the served
    # chunk: bf16 as served (the fused peaks are the main path's answer),
    # then float32 with TF32 off, where the routes differ by summation order
    routes = {}
    for dt, c in (("bfloat16", cfg), ("float32", cfg.replace(compute_dtype="float32"))):
        fm, fp = predictor(c, True, return_heatmaps=True)(frames[:CHUNK])
        mm, mp = predictor(c, False, return_heatmaps=True)(frames[:CHUNK])
        if dt == "bfloat16":
            check(np.array_equal(fp, answers[0]),
                  "fused peaks with maps differ from the main path's answer")
            tol = ROUTE_RTOL * float(np.abs(mm).max())
        else:
            tol = ROUTE_F32_ATOL
        routes[dt] = compare_routes(torch, (fm, fp), (mm, mp), tol, dt)
        del fm, mm
    check(routes["float32"]["clear_share"] >= CLEAR_MIN,
          f"float32: argmax pinned in {routes['float32']['clear_share']} of "
          f"channels, under {CLEAR_MIN}")
    result = {
        "phase": "slice", "device": device_name, "nvidia_smi": smi,
        "model": "BasicNet MODEL_18_POINTS_PER_WING filters 64 bf16, 192x192x4 -> 18",
        "requests": list(REQUESTS), "chunk_size": CHUNK,
        "launches": launches, "encoder_convs_by_kernel": convs,
        "decoder_convs_by_kernel": decoder_convs,
        "decoder_up2_by_kernel": decoder_up2,
        "fused_frames_per_s": n / t_req, "fused_movie_frames_per_s": n / t_movie,
        "module_frames_per_s": n / t_mod, "staging": staged,
        "routes": routes,
    }
    emit(result)
    return result


def compare_routes(torch, fused_out, module_out, tol: float, dt: str) -> dict:
    """Fused vs module (maps, peaks) of one chunk: maps within ``tol``
    everywhere; argmax peaks equal wherever the module map's top-two gap
    exceeds 2 * tol, where no error within ``tol`` can move the argmax;
    peak values within ``tol``."""
    (fm, fp), (mm, mp) = fused_out, module_out
    check(fm.shape == mm.shape and bool(np.isfinite(fm).all()),
          f"{dt}: fused maps {fm.shape}, module maps {mm.shape}")
    err = float(np.abs(fm - mm).max())
    check(err <= tol, f"{dt}: fused vs module maps differ by {err} > {tol}")
    flat = torch.from_numpy(mm).to("cuda").flatten(1, 2)  # (B, H*W, K)
    top2 = flat.topk(2, dim=1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 2 * tol).cpu().numpy()  # (B, K)
    same = (fp[:, :2] == mp[:, :2]).all(axis=1)
    check(bool(same[clear].all()),
          f"{dt}: argmax peaks differ where the top-two gap exceeds {2 * tol}")
    val_err = float(np.abs(fp[:, 2] - mp[:, 2]).max())
    check(val_err <= tol, f"{dt}: peak values differ by {val_err} > {tol}")
    return {"frames": fm.shape[0], "max_abs_err": err, "tol": tol,
            "max_abs_maps": float(np.abs(mm).max()),
            "clear_share": float(clear.mean()), "peaks_same_all": float(same.mean()),
            "peak_val_max_abs_err": val_err}


def phase_int8(torch, cfg, params, frames, device_name: str, smi: str) -> dict:
    """The int8 routes through Predictor at full width."""
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models import quantized
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq

    n = sum(REQUESTS)
    k = 18
    calib = frames[:CALIB_FRAMES]

    def predictor(use_fused: bool, **kw):
        return Predictor(cfg, params, (192, 192, 4), k, device="cuda",
                         chunk_size=CHUNK, use_quantized=True, use_fused=use_fused,
                         calibration_frames=calib, **kw)

    fused = predictor(True)
    check(fused.serving_path == "int8_fused", f"serving_path {fused.serving_path}")
    fused(frames[:1])  # warm-up

    # ---- the int8 path: counter zeroed just before, read just after ----
    hq.fused_quantized_stage.launches = 0
    hq.fused_quantized_stage.convs_by_kernel = dict.fromkeys(hq.QCONV_KERNEL_CODES, 0)
    packs = hq.pack_qconv_weights.launches
    answers, movie, t_req, t_movie = serve(fused, frames)
    launches = hq.fused_quantized_stage.launches
    convs = dict(hq.fused_quantized_stage.convs_by_kernel)
    # ---------------------------------------------------------------------
    chunks = sum(-(-r // CHUNK) for r in REQUESTS) + -(-n // CHUNK)
    check(launches == 3 * chunks,
          f"fused_quantized_stage launched {launches} times, expected {3 * chunks}")
    check(convs == {"dp4a": 0, "mma_s8": 8 * chunks, "mma_s8_c4": chunks},
          f"the served int8 convs took {convs}: all belong on the tensor cores, "
          "the 4-channel first conv on its own kernel")
    check(hq.pack_qconv_weights.launches == packs,
          "serving packed weights again: they are packed once, with the predictor")
    check_peaks(answers, movie, n, k)

    resident = predictor(False)
    check(resident.serving_path == "int8_resident", resident.serving_path)
    resident(frames[:1])
    res_answers, res_movie, t_res, _ = serve(resident, frames)
    check_peaks(res_answers, res_movie, n, k)
    check(hq.fused_quantized_stage.launches == launches,
          "the resident route launched the stage kernel")

    # one chunk's maps: fused vs the bf16-activation int8 forward, then both
    # int8 routes vs the bf16 module route, from the predictors that served
    one = frames[:CHUNK]
    fused.return_heatmaps = resident.return_heatmaps = True
    fm, fp = fused(one)
    rm, rp = resident(one)
    check(np.array_equal(fp, answers[0]),
          "int8_fused peaks with maps differ from the int8 path's answer")
    check(np.array_equal(rp, res_answers[0]),
          "int8_resident peaks with maps differ from its served answer")
    scales = quantized.calibrate(params, calib, device="cuda")
    with torch.inference_mode():
        ref = quantized.make_quantized_forward(params, scales, device="cuda")(
            torch.from_numpy(one).to("cuda")).cpu().numpy()
    check(fm.shape == ref.shape and bool(np.isfinite(fm).all()),
          f"int8_fused maps {fm.shape}, reference {ref.shape}")
    top = float(np.abs(ref).max())
    err = float(np.abs(fm - ref).max())
    corr = float(np.corrcoef(fm.ravel()[::7], ref.ravel()[::7])[0, 1])
    check(err < INT8_FUSED_RTOL * top,
          f"int8_fused vs make_quantized_forward: {err} >= {INT8_FUSED_RTOL} * {top}")
    check(corr > INT8_FUSED_CORR, f"int8_fused vs make_quantized_forward: corr {corr}")
    del ref
    mm, mp = Predictor(cfg, params, (192, 192, 4), k, device="cuda", chunk_size=CHUNK,
                       return_heatmaps=True)(one)
    mtop = float(np.abs(mm).max())
    vs_bf16 = {}
    for name, maps, pts in (("int8_fused", fm, fp), ("int8_resident", rm, rp)):
        e = float(np.abs(maps - mm).max())
        check(e <= INT8_VS_BF16_RTOL * mtop,
              f"{name} vs module maps: {e} > {INT8_VS_BF16_RTOL} * {mtop}")
        dist = np.hypot(pts[:, 0] - mp[:, 0], pts[:, 1] - mp[:, 1])
        vs_bf16[name] = {
            "max_abs_err": e, "rel_of_max": e / mtop,
            "mean_abs_err": float(np.abs(maps - mm).mean()),
            "peaks_same_share": float((dist == 0).mean()),
            "peaks_within_2px_share": float((dist <= 2).mean())}
    result = {
        "phase": "int8", "device": device_name, "nvidia_smi": smi,
        "model": "BasicNet MODEL_18_POINTS_PER_WING filters 64 int8, 192x192x4 -> 18",
        "requests": list(REQUESTS), "chunk_size": CHUNK,
        "calibration_frames": CALIB_FRAMES,
        "launches": {"fused_quantized_stage": launches},
        "int8_convs_by_kernel": convs,
        "int8_fused_frames_per_s": n / t_req,
        "int8_fused_movie_frames_per_s": n / t_movie,
        "int8_resident_frames_per_s": n / t_res,
        "fused_vs_quantized_forward": {
            "max_abs_err": err, "max_abs_maps": top, "rtol": INT8_FUSED_RTOL,
            "corr": corr, "corr_min": INT8_FUSED_CORR},
        "vs_bf16_module": {"max_abs_maps": mtop, "rtol": INT8_VS_BF16_RTOL, **vs_bf16},
    }
    emit(result)
    return result


def phase_im2col(torch, device_name: str, smi: str) -> dict:
    """Counterpart of scripts/exp_im2col_pallas.py's main: exactness first,
    then microseconds per frame and effective TOP/s, kernel and plain."""
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq

    x, w, mult, bias = im2col_inputs(torch, IM2COL_BATCH)
    hq.quantized_conv3x3.launches = 0
    got = hq.quantized_conv3x3(x, w, mult, bias)
    torch.cuda.synchronize()
    k_ms = time_ms(torch, lambda: hq.quantized_conv3x3(x, w, mult, bias), reps=50)
    launches = hq.quantized_conv3x3.launches
    ref = hq.quantized_conv3x3_plain(x, w, mult, bias)
    maxdiff = int((got.int() - ref.int()).abs().max())
    check(bool(torch.equal(got, ref)), f"im2col conv differs from plain by {maxdiff}")
    p_ms = time_ms(torch, lambda: hq.quantized_conv3x3_plain(x, w, mult, bias), reps=5)
    ops = 2 * 192 * 192 * 9 * 64 * 64  # per frame
    result = {"phase": "im2col", "device": device_name, "nvidia_smi": smi,
              "exact": True, "maxdiff": maxdiff, "batch": IM2COL_BATCH,
              "launches": launches}
    for name, ms in (("kernel", k_ms), ("plain", p_ms)):
        us = ms * 1e3 / IM2COL_BATCH
        result[name] = {"us_per_frame": us, "eff_TOPs": ops / (us * 1e-6) / 1e12}
    emit(result)
    return result


def phase_lift(torch) -> None:
    from pose_estimation_amitai_torch.constants import SENSOR_HEIGHT
    from pose_estimation_amitai_torch.infer import lift_to_3d

    rng = np.random.default_rng(SEED + 1)
    n_frames, n_pts = 4, 18
    pts3d = rng.uniform(-0.004, 0.004, (n_frames, n_pts, 3))
    cams = []
    for yaw, pitch in ((0.0, 0.3), (1.6, -0.2), (3.1, 0.25), (4.7, -0.3)):
        cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
        rot = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]]) @ np.array(
            [[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        center = rot.T @ np.array([0.0, 0.0, -0.25])  # 25 cm from the origin
        kmat = np.array([[3000.0, 0, 640], [0, 3000.0, 400], [0, 0, 1]])
        cams.append(kmat @ np.hstack([rot, -(rot @ center)[:, None]]))
    cams = np.stack(cams)  # (4, 3, 4)
    hom = np.concatenate([pts3d, np.ones((n_frames, n_pts, 1))], -1)
    uvw = np.einsum("cij,fnj->fcni", cams, hom)
    uv = uvw[..., :2] / uvw[..., 2:3]  # (F, 4, N, 2) full-sensor [x, y]
    crop = np.stack([  # [y_crop, x_crop]: a 192 crop around each view's points
        (SENSOR_HEIGHT + 1) - uv[..., 1].mean(-1) - 96, uv[..., 0].mean(-1) - 96,
    ], -1).round()
    local = np.stack([uv[..., 0] - crop[..., 1:2],
                      (SENSOR_HEIGHT + 1) - uv[..., 1] - crop[..., 0:1]], -1)
    check(bool(((local >= 0) & (local < 192)).all()), "synthetic peaks outside crops")
    got = lift_to_3d(local, crop, cams, device="cuda")
    spread = float(np.ptp(pts3d))
    err = float(np.abs(got - pts3d).max())
    check(got.shape == (n_frames, n_pts, 3), f"lift shape {got.shape}")
    check(err <= LIFT_RTOL * spread, f"3D error {err} > {LIFT_RTOL} * {spread}")
    emit({"phase": "lift", "frames": n_frames, "points": n_pts,
          "max_abs_err": err, "spread": spread, "rtol": LIFT_RTOL})


def vit_params(cfg, in_channels: int, out_channels: int, four: bool) -> dict:
    """Seeded flax-layout params of the ViT ``cfg`` builds, at its widths."""
    from pose_estimation_amitai_torch import weights

    return weights.init_vit_params(
        np.random.default_rng(SEED), in_channels, out_channels, 192,
        patch_size=cfg.patch_size, dim=cfg.projection_dim,
        depth=cfg.transformer_layers, heads=cfg.num_heads,
        dim_head=cfg.projection_dim if cfg.dim_head else 64,
        mlp_expand=cfg.fully_connected_expand, kernel_size=cfg.kernel_size,
        four_cameras=four)


def phase_vit(torch, frames, movie, device_name: str, smi: str) -> dict:
    """ViT serving through Predictor at full width: the fused route (the
    attention kernel) and the module route."""
    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_attention as ha

    n = sum(REQUESTS)
    k = 18
    cfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT)
    check((cfg.projection_dim, cfg.transformer_layers, cfg.num_heads, cfg.patch_size,
           cfg.fully_connected_expand, bool(cfg.dim_head), cfg.compute_dtype)
          == (256, 8, 8, 16, 4, True, "bfloat16"), "Config() ViT defaults changed")
    params = vit_params(cfg, 4, k, four=False)

    def predictor(c, **kw):
        return Predictor(c, params, (192, 192, 4), k, device="cuda", chunk_size=CHUNK, **kw)

    fused = predictor(cfg, use_fused=True)
    check(fused.serving_path == "fused" and fused.model.fused_attention
          and not fused.model.fast_softmax, f"serving_path {fused.serving_path}")
    fused(frames[:1])  # warm-up: allocator, library load

    # ---- the ViT path: counter zeroed just before, read just after ----
    ha.fused_attention.launches = 0
    ha.fused_attention.launches_by_kernel = dict.fromkeys(ha.KERNEL_CODES, 0)
    answers, movie_peaks, t_req, t_movie = serve(fused, frames)
    launches = ha.fused_attention.launches
    by_kernel = dict(ha.fused_attention.launches_by_kernel)
    # --------------------------------------------------------------------
    chunks = sum(-(-r // CHUNK) for r in REQUESTS) + -(-n // CHUNK)
    depth = cfg.transformer_layers
    check(by_kernel == {"fma": 0, "mma": launches},
          f"the served attention launches took {by_kernel}")
    check(launches == depth * chunks,
          f"fused_attention launched {launches} times, expected {depth * chunks}")
    check_peaks(answers, movie_peaks, n, k)

    # ---- the staging movie: counter zeroed just before, read just after ----
    def zero_attention():
        ha.fused_attention.launches = 0

    staged = staging(torch, fused, movie,
                     lambda: {"fused_attention": ha.fused_attention.launches}, zero_attention)
    for p, got in staged["launches"].items():
        check(got == {"fused_attention": depth * MOVIE_CHUNKS},
              f"the movie at prefetch {p} launched {got}")
    before_module = ha.fused_attention.launches

    rates = {}
    for name, kw in (("module", {}), ("module_exact_softmax", {"fast_softmax": False})):
        pred = predictor(cfg, **kw)
        check(pred.serving_path == "module"
              and pred.model.fast_softmax is (name == "module"), name)
        pred(frames[:1])
        ans, mov, t, _ = serve(pred, frames)
        check_peaks(ans, mov, n, k)
        rates[name + "_frames_per_s"] = n / t
    check(ha.fused_attention.launches == before_module,
          "the module route launched the attention kernel")

    # one chunk's normalised maps and peaks, fused vs module (exact softmax
    # on both: maps are returned): float32 with TF32 off, where the routes
    # differ by summation order, then bf16 as served
    routes = {}
    for dt, c in (("float32", cfg.replace(compute_dtype="float32")), ("bfloat16", cfg)):
        fm, fp = predictor(c, use_fused=True, return_heatmaps=True)(frames[:CHUNK])
        mm, mp = predictor(c, return_heatmaps=True)(frames[:CHUNK])
        if dt == "bfloat16":
            # peaks-only serving decoded the raw maps and rescaled the vals
            check(np.array_equal(fp, answers[0]),
                  "fused peaks with maps differ from the ViT path's answer")
            tol = ROUTE_RTOL * float(np.abs(mm).max())
        else:
            tol = VIT_F32_ATOL
        routes[dt] = compare_routes(torch, (fm, fp), (mm, mp), tol, dt)
        del fm, mm
    result = {
        "phase": "vit", "device": device_name, "nvidia_smi": smi,
        "model": "ViTPoseNet MODEL_18_POINTS_PER_WING_VIT patch 16 dim 256 depth 8 "
                 "heads 8 dim_head 256 mlp 1024 bf16, 192x192x4 -> 18",
        "requests": list(REQUESTS), "chunk_size": CHUNK,
        "launches": {"fused_attention": launches},
        "attention_launches_by_kernel": by_kernel,
        "fused_frames_per_s": n / t_req, "fused_movie_frames_per_s": n / t_movie,
        **rates, "staging": staged, "routes": routes,
    }
    emit(result)
    return result


def phase_vit4cam(torch, device_name: str, smi: str) -> None:
    """The 4-camera ViT at full width: one chunk of 64 frames with the views
    folded into the batch (chunk 64) and one by one (chunk 128), fused vs
    module. Frames are 4 views x 4 channels on the channel axis, as the
    preprocessor lays this model type out."""
    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_attention as ha

    k, shape = 72, (192, 192, 16)
    cfg = Config(model_type=C.ALL_CAMS_18_POINTS_VIT)
    params = vit_params(cfg, shape[-1], k, four=True)
    frames = np.random.default_rng(SEED + 2).random((VIT4_FRAMES, *shape), dtype=np.float32)
    depth, fuse = cfg.transformer_layers, 4
    result = {"phase": "vit4cam", "device": device_name, "nvidia_smi": smi,
              "model": "ViT4Cameras ALL_CAMS_18_POINTS_VIT dim 256 depth 8 heads 8 "
                       "dim_head 256, 4 fusion blocks (dim 1280, heads 4), bf16, "
                       "192x192x16 -> 72", "frames": VIT4_FRAMES}
    fused_maps = {}
    for name, chunk, want in (("folded", VIT4_FRAMES, depth + fuse),
                              ("unfolded", 128, 4 * (depth + fuse))):
        def predictor(**kw):
            return Predictor(cfg, params, shape, k, device="cuda", chunk_size=chunk, **kw)

        fused = predictor(use_fused=True)
        check(fused.serving_path == "fused"
              and fused.model.fold_views is (name == "folded"), name)
        fused(frames[:1])
        ha.fused_attention.launches = 0
        ha.fused_attention.launches_by_kernel = dict.fromkeys(ha.KERNEL_CODES, 0)
        t0 = time.perf_counter()
        pts = fused(frames)
        t_fused = time.perf_counter() - t0
        launches = ha.fused_attention.launches
        check(launches == want, f"{name}: {launches} attention launches, expected {want}")
        check(ha.fused_attention.launches_by_kernel["mma"] == want,
              f"{name}: launches by kernel {ha.fused_attention.launches_by_kernel}")
        check(pts.shape == (VIT4_FRAMES, 3, k) and bool(np.isfinite(pts).all()),
              f"{name}: peaks {pts.shape}")
        module = predictor()
        module(frames[:1])
        t0 = time.perf_counter()
        module(frames)
        t_module = time.perf_counter() - t0
        fm, fp = predictor(use_fused=True, return_heatmaps=True)(frames)
        mm, mp = predictor(return_heatmaps=True)(frames)
        check(np.array_equal(fp, pts), f"{name}: peaks with maps differ from peaks-only")
        cmp = compare_routes(torch, (fm, fp), (mm, mp),
                             ROUTE_RTOL * float(np.abs(mm).max()), f"{name} bfloat16")
        fused_maps[name] = fm
        result[name] = {"chunk_size": chunk, "launches": launches,
                        "fused_frames_per_s": VIT4_FRAMES / t_fused,
                        "module_frames_per_s": VIT4_FRAMES / t_module,
                        "fused_vs_module": cmp}
        del mm
    diff = float(np.abs(fused_maps["folded"] - fused_maps["unfolded"]).max())
    check(diff <= VIT4_FOLD_RTOL, f"folded vs unfolded maps differ by {diff}")
    result["folded_vs_unfolded_max_abs"] = diff
    emit(result)


def graph_ms(torch, fn, reps: int, replays: int = 5) -> float:
    """Mean device milliseconds of ``fn()`` with no host dispatch in the
    window: ``reps`` calls captured in one CUDA graph (the wrappers launch on
    the current stream, which is the capture stream), the graph replayed
    ``replays`` times between two CUDA events. A replay counts no launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


LAUNCH_REPS = 200  # calls a turn when timing the launch path's costs


def launch_path_costs(torch, hp, a, b) -> dict:
    """Per-call milliseconds of int8_vector_arith(a, b) on its 16-byte kernel
    through copies of the launch path, each with one more host cost taken
    out, timed in turns in one run: (1) the byte-wise kernels' earlier path
    (the library and its function looked up at every call, a
    torch.cuda.device context, a Stream object built for the raw stream);
    (2) the function resolved once; (3) and no device context (the C entry
    guards the device); (4) and the raw stream from PyTorch's getter: the
    wrapper's own path without its rule and counters; (5) the wrapper; (6)
    the ctypes call alone on a preallocated output; (7) torch.add(b, a,
    alpha=2)."""
    from pose_estimation_amitai_torch.ops import _build, hopper_conv

    fns = hp._fns()
    code, dev = hp.KERNEL_CODES["vec16"], a.get_device()
    out = torch.empty_like(a)
    raw = fns.stream(dev)

    def looked_up_each_call():
        hp._check("a", a, torch.int8, a.dim())
        hopper_conv.check_operand("b", b, tuple(a.shape), torch.int8, a.device)
        o = torch.empty_like(a)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            args = (lambda o: (a.data_ptr(), b.data_ptr(), o.data_ptr(), a.numel()))(o)
            getattr(_build.load("probes"), "pe_probe_int8_axpb")(code, *args, dev, stream)
        return o

    def resolved_once():
        hp._check("a", a, torch.int8, a.dim())
        hopper_conv.check_operand("b", b, tuple(a.shape), torch.int8, a.device)
        o = torch.empty_like(a)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            fns.int8_axpb(code, a.data_ptr(), b.data_ptr(), o.data_ptr(), a.numel(), dev, stream)
        return o

    def no_device_context():
        hp._check("a", a, torch.int8, a.dim())
        hopper_conv.check_operand("b", b, tuple(a.shape), torch.int8, a.device)
        o = torch.empty_like(a)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        fns.int8_axpb(code, a.data_ptr(), b.data_ptr(), o.data_ptr(), a.numel(), dev, stream)
        return o

    def raw_stream():
        hp._check("a", a, torch.int8, a.dim())
        hopper_conv.check_operand("b", b, tuple(a.shape), torch.int8, a.device)
        o = torch.empty_like(a)
        fns.int8_axpb(code, a.data_ptr(), b.data_ptr(), o.data_ptr(), a.numel(), dev,
                      fns.stream(dev))
        return o

    def ctypes_alone():
        fns.int8_axpb(code, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), dev, raw)
        return out

    variants = {"looked_up_each_call": looked_up_each_call,
                "function_resolved_once": resolved_once,
                "and_no_device_context": no_device_context,
                "and_raw_stream": raw_stream,
                "wrapper": lambda: hp.int8_vector_arith(a, b),
                "ctypes_call_alone": ctypes_alone,
                "torch_add": lambda: torch.add(b, a, alpha=2)}
    want = hp.int8_vector_arith_plain(a, b)
    for name, fn in variants.items():  # each computes the probe's answer
        got = fn()
        torch.cuda.synchronize()
        check(bool(torch.equal(got, want)), f"launch path {name} differs from plain")
    order = list(variants) + list(reversed(variants))  # in turns, there and back
    times = {name: [] for name in variants}
    for name in order:
        times[name].append(time_ms(torch, variants[name], LAUNCH_REPS))
    return {name: sum(t) / len(t) for name, t in times.items()}


def phase_probes(torch, device_name: str, smi: str) -> list[dict]:
    """The probe kernels on the two experiment scripts' inputs, each equal to
    its plain version: the bisect script's five cases and its two full-conv
    sizes, and the six probes of the Mosaic script's main. Each is timed per
    call (``ms``: CUDA events around 20 back-to-back calls, what a caller
    sees, host dispatch included) and on the device alone (``device_ms``:
    the 20 calls captured in a CUDA graph and replayed), beside the kernel it
    replaced on the same tensors (``previous_ms``: the byte-wise kernels; for
    full_epilogue the im2col weights packed at every call) and the one
    PyTorch call of the same function where there is one (``library_ms``,
    ``library_device_ms``). Returns the two rows of the kernels line."""
    from pose_estimation_amitai_torch.ops import hopper_probes as hp
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq

    x = hp.run_case_input("cuda")
    full = {g: hp.run_full_inputs(g, "cuda") for g in (1, 4)}
    # the weights packed once, before anything is timed, as device_layers
    # packs a served stage's
    packed = {g: (xg, hq.pack_qconv_weights(hp._hwio(w)), m, bias)
              for g, (xg, w, m, bias) in full.items()}
    a = torch.arange(8 * 128, device="cuda").to(torch.int8).reshape(8, 128)
    b = torch.ones((8, 128), dtype=torch.int8, device="cuda")
    ones = {n: torch.ones((n, 8, 128), device="cuda") for n in (8, 16, 32, 64)}
    xi = torch.ones((16, 8, 128), dtype=torch.int8, device="cuda")
    # (name, kernel, plain, the one PyTorch call of the same function or
    # None, the kernel before on the same tensors, the by-kernel counter)
    def bisect_spec(probe, library):
        name = probe.__name__
        return (name, lambda: probe(x), lambda: getattr(hp, name + "_plain")(x), library,
                lambda: getattr(hp, name + "_on")("byte", x), probe.launches_by_kernel)

    bisect_specs = [
        bisect_spec(hp.k_copy, x.clone), bisect_spec(hp.k_stage, x.clone),
        bisect_spec(hp.k_dyn_read, x.clone), bisect_spec(hp.k_reshape, x.clone),
        bisect_spec(hp.k_concat_dot, None),
    ] + [
        (f"full_epilogue_grid{g}", lambda g=g: hp.full_epilogue(*packed[g]),
         lambda g=g: hp.full_epilogue_plain(*full[g]), None,
         lambda g=g: hp.full_epilogue(*full[g]), hq.quantized_conv3x3.launches_by_kernel)
        for g in full
    ]
    # a * 2 + b wrapping in int8 is one PyTorch call; held equal before timing
    check(bool(torch.equal(torch.add(b, a, alpha=2), hp.int8_vector_arith_plain(a, b))),
          "torch.add(b, a, alpha=2) differs from int8_vector_arith_plain")
    mosaic_specs = [
        ("int8_vector_arith", lambda: hp.int8_vector_arith(a, b),
         lambda: hp.int8_vector_arith_plain(a, b), lambda: torch.add(b, a, alpha=2),
         lambda: hp.int8_vector_arith_on("byte", a, b), hp.int8_vector_arith.launches_by_kernel),
    ] + [
        (f"grid_{n}", lambda n=n: hp.grid_scale(ones[n]),
         lambda n=n: hp.grid_scale_plain(ones[n]), lambda n=n: torch.mul(ones[n], 2.0),
         lambda n=n: hp.grid_scale_on("byte", ones[n]), hp.grid_scale.launches_by_kernel)
        for n in ones
    ] + [
        ("int8_int32_grid_16", lambda: hp.int8_vector_in_grid(xi),
         lambda: hp.int8_vector_in_grid_plain(xi), None,
         lambda: hp.int8_vector_in_grid_on("byte", xi),
         hp.int8_vector_in_grid.launches_by_kernel),
    ]

    # ---- the probes, once each as the scripts run them: counters zeroed
    # just before, read just after ----
    for fn in hp.PROBES:
        fn.launches = 0
        fn.launches_by_kernel.update(dict.fromkeys(hp.KERNEL_CODES, 0))
    full_before = hq.quantized_conv3x3.launches
    outs, kernels = {}, {}
    for name, kernel, _, _, _, counter in bisect_specs + mosaic_specs:
        outs[name], kernels[name] = took(counter, kernel)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in hp.PROBES}
    launches["full_epilogue"] = hq.quantized_conv3x3.launches - full_before
    # -------------------------------------------------------------------
    check(launches == {"k_copy": 1, "k_stage": 1, "k_dyn_read": 1, "k_reshape": 1,
                       "k_concat_dot": 1, "full_epilogue": 2, "int8_vector_arith": 1,
                       "grid_scale": 4, "int8_vector_in_grid": 1},
          f"probe launch counts {launches}")
    want_kernels = {name: "mma_s8" if name.startswith("full") else "vec16" for name in kernels}
    check(kernels == want_kernels,
          f"the probes took {kernels}: at C = 64, aligned, every probe of "
          "probes.cu belongs on its 16-byte kernel")
    # the scripts' own expectations
    check(bool(torch.equal(outs["int8_vector_arith"], (a.int() * 2 + 1).to(torch.int8))),
          "int8 a * 2 + b did not wrap")
    check(all(bool((outs[f"grid_{n}"] == 2.0).all()) for n in ones), "a grid probe is not 2.0")
    check(bool((outs["int8_int32_grid_16"] == 2).all()), "int8_int32_grid_16 is not 2")

    def compare(name, kernel_fn, plain_fn, library_fn, previous_fn, _) -> dict:
        got, want = outs[name], plain_fn()
        check(got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.equal(got, want)), f"probe {name} differs from plain")
        check(bool(torch.equal(previous_fn(), want)),
              f"probe {name}: the kernel before differs from plain")
        conv = "dot" in name or "full" in name
        ops = 2.0 * 9 * want.numel() * want.shape[-1] if conv else 0.0
        reads = 2 if name == "int8_vector_arith" else 1  # inputs of the output's size
        bnd = bound(ops, "int8", (reads + 1) * nbytes(want))
        k_ms, p_ms, l_ms = compare_timed(torch, kernel_fn, plain_fn, 20, library_fn)
        return {"probe": name, "shape": list(want.shape),
                "dtype": str(want.dtype).removeprefix("torch."), "max_abs_err": 0.0,
                "kernel": kernels[name],
                "ms": k_ms, "device_ms": graph_ms(torch, kernel_fn, 20),
                "previous_ms": time_ms(torch, previous_fn, 20),
                "previous_device_ms": graph_ms(torch, previous_fn, 20),
                "plain_ms": p_ms, "library_ms": l_ms,
                "library_device_ms": graph_ms(torch, library_fn, 20) if library_fn else None,
                "bound_ms": bnd[0], "bound_by": bnd[1]}

    bisect = [compare(*spec) for spec in bisect_specs]
    mosaic = [compare(*spec) for spec in mosaic_specs]
    launch_path = launch_path_costs(torch, hp, a, b)
    csrc = "pose_estimation_amitai_torch/csrc/probes.cu"
    rows = []
    for name, cases, replaces, names in (
        ("bisect_probes", bisect, "scripts/exp_im2col_bisect.py:21",
         ("k_copy", "k_stage", "k_dyn_read", "k_reshape", "k_concat_dot", "full_epilogue")),
        ("mosaic_probes", mosaic, "scripts/exp_mosaic_probe.py:37",
         ("int8_vector_arith", "grid_scale", "int8_vector_in_grid")),
    ):
        # the probes that one PyTorch call computes: clone for the copies,
        # torch.mul for grid_scale, torch.add for int8_vector_arith
        lib = [c for c in cases if c["library_ms"] is not None]
        rows.append({
            "name": name, "route": "cuda", "source": csrc, "replaces": replaces,
            "launches": sum(launches[k] for k in names),
            "max_abs_err": 0.0, "tolerance": "outputs equal",
            # summed over the probes, one launch each
            "ms": sum(c["ms"] for c in cases),
            "device_ms": sum(c["device_ms"] for c in cases),
            "previous_ms": sum(c["previous_ms"] for c in cases),
            "previous_device_ms": sum(c["previous_device_ms"] for c in cases),
            "device_method": "cuda_graph",
            "kernel": [c["kernel"] for c in cases],
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": max(cases, key=lambda c: c["bound_ms"])["bound_by"],
            # summed over those probes, beside the kernels' time on them
            "library_ms": sum(c["library_ms"] for c in lib),
            "library_device_ms": sum(c["library_device_ms"] for c in lib),
            "library_probes": [c["probe"] for c in lib],
            "ms_of_library_probes": sum(c["ms"] for c in lib),
            "device_ms_of_library_probes": sum(c["device_ms"] for c in lib),
        })
    emit({"phase": "probes", "device": device_name, "nvidia_smi": smi,
          "launches": launches, "device_method": "cuda_graph",
          "bisect": bisect, "mosaic": mosaic, "launch_path_ms": launch_path})
    return rows


def phase_train(torch, device_name: str, smi: str) -> dict:
    """Flagship training at Config()'s defaults through the port's entry
    points, on the card; the trained weights then served through the
    encoder-stage and decoder kernels."""
    import tempfile

    from pose_estimation_amitai_torch import Config, weights
    from pose_estimation_amitai_torch.data import build_dataset
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.train import checkpoint, loop

    t_phase = time.perf_counter()
    cfg = Config()
    check((cfg.model_type, cfg.num_base_filters, cfg.kernel_size, cfg.dilation_rate,
           cfg.batch_size, cfg.accumulation_steps, cfg.do_augmentations,
           cfg.rotation_range, cfg.xy_shifts, cfg.horizontal_flip, cfg.vertical_flip,
           cfg.interpolation_order, cfg.dropout_ratio, cfg.learning_rate,
           cfg.compute_dtype)
          == ("MODEL_18_POINTS_PER_WING", 64, 3, 2, 8, 1, True, 30.0, 10.0, True, True,
              1, 0.5, 1e-3, "bfloat16"), "Config() training defaults changed")

    # (a) the dataset on the card
    t0 = time.perf_counter()
    arrays = train_arrays()
    ds, _ = build_dataset(cfg, arrays, device="cuda")
    t_data = time.perf_counter() - t0
    n, k = 8 * TRAIN_FRAMES, TRAIN_POINTS // 2 + 2
    check(tuple(ds.data["box"].shape) == (n, 192, 192, 4)
          and tuple(ds.data["confmaps"].shape) == (n, 192, 192, k)
          and tuple(ds.data["peaks"].shape) == (n, k, 2)
          and all(v.is_cuda for v in ds.data.values()),
          f"dataset {({key: tuple(v.shape) for key, v in ds.data.items()})}")
    check(len(ds.val_inds) == n // 2 and len(ds.train_inds) == n // 2,
          f"split {len(ds.train_inds)} / {len(ds.val_inds)}")
    with torch.device("meta"):  # the geometry only; parameters live in the state
        model = build_model(cfg, (192, 192, 4), k)

    # (b) steps at the defaults: bf16 compute, augmentation, dropout 0.5, Adam
    state0 = loop.create_train_state(model, cfg, seed=SEED, device="cuda")
    step = loop.make_train_step(model, cfg)
    frames_per_step = cfg.batch_size * cfg.accumulation_steps
    idx = [ds.step_indices(cfg.batch_size, cfg.accumulation_steps)
           for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    state, losses = state0, []
    for i in range(TRAIN_WARMUP):
        state, loss = step(state, ds.data, idx[i])
        losses.append(loss)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        state, loss = step(state, ds.data, idx[i])
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), f"non-finite losses {losses}")
    still = [name for name, p in state.params.items()
             if torch.equal(p, state0.params[name])]
    check(not still, f"parameters that never moved: {still}")
    check(all(p.is_cuda and p.dtype == torch.float32 for p in state.params.values()),
          "the trained parameters left the card or float32")
    trained = state
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    warp = warp_timings(torch, cfg, ds.data["box"])
    by_method = step_ms_by_method(torch, step, state, ds, cfg)

    # (c) one float32 step (TF32 off, dropout 0, targets from peaks), card vs
    # CPU, and (d) below, with deterministic cuDNN: the step's gradients are
    # then those grad_fn gives, and a rerun repeats them
    torch.backends.cudnn.deterministic = True
    cfg32 = cfg.replace(compute_dtype="float32", dropout_ratio=0.0, do_augmentations=False)
    with torch.device("meta"):
        model32 = build_model(cfg32, (192, 192, 4), k)
    grad_fn = loop.make_grad_fn(model32, cfg32)
    step32 = loop.make_train_step(model32, cfg32)
    data_cpu = {key: v.cpu() for key, v in ds.data.items()}
    one = {}
    for dev, data in (("cuda", ds.data), ("cpu", data_cpu)):
        st = loop.create_train_state(model32, cfg32, seed=SEED, device=dev)
        loss, grads = grad_fn(st.params, data, idx[0][0], torch.Generator(device=dev))
        new, step_loss = step32(st, data, idx[0])
        one[dev] = (float(loss), float(step_loss),
                    {key: g.cpu().numpy() for key, g in grads.items()},
                    {key: p.cpu().numpy() for key, p in new.params.items()})
    (lg, slg, gg, pg), (lc, slc, gc, pc) = one["cuda"], one["cpu"]
    check(slg == lg and slc == lc, f"the step's loss is not its gradient's loss: card "
          f"{slg!r} vs {lg!r}, CPU {slc!r} vs {lc!r}")
    loss_err = abs(lg - lc) / abs(lc)
    check(loss_err <= TRAIN_LOSS_RTOL, f"card vs CPU loss {lg} vs {lc}")
    grad_err, param_err, unexplained, flips = 0.0, 0.0, 0.0, 0
    for key in gc:
        top = float(np.abs(gc[key]).max())
        grad_err = max(grad_err, float(np.abs(gg[key] - gc[key]).max()) / top)
        same = np.sign(gg[key]) == np.sign(gc[key])
        flips += int((~same).sum())
        check(float(np.abs(gc[key][~same]).max(initial=0.0)) <= TRAIN_GRAD_RTOL * top,
              f"{key}: a gradient sign differs away from zero")
        explained = cfg32.learning_rate * ADAM_EPS * np.abs(gg[key] - gc[key]) / (
            (np.abs(gg[key]) + ADAM_EPS) * (np.abs(gc[key]) + ADAM_EPS))
        d = np.abs(pg[key] - pc[key])[same]
        param_err = max(param_err, float(d.max(initial=0.0)))
        unexplained = max(unexplained, float((d - explained[same]).max(initial=0.0)))
    check(grad_err <= TRAIN_GRAD_RTOL, f"card vs CPU gradients differ by {grad_err} of max")
    check(unexplained <= TRAIN_PARAM_ATOL,
          f"card vs CPU updated parameters differ by {unexplained} beyond their gradients'")
    del data_cpu, one, gg, gc, pg, pc

    # (d) true resume: RESUME_STEPS through a checkpoint equal as many steps
    # in one go
    whole, whole_losses = state0, []
    for i in range(sum(RESUME_STEPS)):
        whole, loss = step(whole, ds.data, idx[i])
        whole_losses.append(float(loss))
    part, part_losses = state0, []
    for i in range(RESUME_STEPS[0]):
        part, loss = step(part, ds.data, idx[i])
        part_losses.append(float(loss))
    with tempfile.TemporaryDirectory() as run_dir:
        checkpoint.save_checkpoint(run_dir, part, epoch=0, val_loss=part_losses[-1])
        fresh = loop.create_train_state(model, cfg, seed=SEED + 1, device="cuda")
        part, meta = checkpoint.restore_checkpoint(run_dir, fresh)
    check(part.step == RESUME_STEPS[0] and meta["epoch"] == 0, f"restored {part.step}")
    for i in range(RESUME_STEPS[0], sum(RESUME_STEPS)):
        part, loss = step(part, ds.data, idx[i])
        part_losses.append(float(loss))
    torch.backends.cudnn.deterministic = False
    differ = [name for name in whole.params
              if not torch.equal(whole.params[name], part.params[name])]
    check(part_losses == whole_losses and not differ,
          f"resumed run differs: losses {part_losses} vs {whole_losses}, params {differ}")

    # (e) the eval step over the validation split
    evaluate = loop.make_eval_step(model, cfg)
    mses, l2s = [], []
    for batch, m in ds.val_payloads(cfg.batch_size):
        mse, l2 = evaluate(trained, batch)
        check(tuple(l2.shape) == (m, k), f"l2 {tuple(l2.shape)}")
        mses.append(float(mse))
        l2s.append(l2.cpu().numpy())
    l2s = np.concatenate(l2s)
    check(len(l2s) == n // 2 and bool(np.isfinite(mses).all() and np.isfinite(l2s).all()),
          "eval: non-finite or missing values")

    # (f) the trained weights served through the kernels
    pred = Predictor(cfg, weights.basicnet_params_from_state_dict(trained.params),
                     (192, 192, 4), k, use_fused=True, device="cuda", chunk_size=CHUNK,
                     return_heatmaps=True)
    check(pred.serving_path == "fused", f"serving_path {pred.serving_path}")
    frames = torch.cat([ds.data["box"], ds.data["box"].flip(1)]).cpu().numpy()
    pred(frames[:1])  # warm-up
    # ---- the served chunk: counters zeroed just before, read just after ----
    zero_conv_counters(hc, hd)
    maps, pts = pred(frames)
    launches = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                "fused_decoder": hd.fused_decoder.launches}
    convs = dict(hc.fused_encoder_stage.convs_by_kernel)
    decoder_convs = dict(hd.fused_decoder.convs_by_kernel)
    decoder_up2 = dict(hd.fused_decoder.up2_by_kernel)
    # -----------------------------------------------------------------------
    check(launches == {"fused_encoder_stage": 3, "fused_decoder": 1}
          and convs == {"fma": 0, "mma_c4": 1, "wgmma": 8}
          and decoder_convs == {"fma": 0, "wgmma": 2} and decoder_up2 == {"fma": 0, "mma": 2},
          f"the trained weights' chunk took {launches}, {convs}, {decoder_convs}, "
          f"{decoder_up2}: not every conv on the tensor cores")
    check(maps.shape == (CHUNK, 192, 192, k) and pts.shape == (CHUNK, 3, k)
          and bool(np.isfinite(pts).all()), f"served {maps.shape} {pts.shape}")
    want = loop.make_predict_fn(model)(trained.params,
                                       torch.from_numpy(frames).to("cuda")).cpu().numpy()
    top = float(np.abs(want).max())
    serve_err = float(np.abs(maps - want).max())
    check(serve_err <= ROUTE_RTOL * top,
          f"served vs trained module maps: {serve_err} > {ROUTE_RTOL} * {top}")

    steps_per_s = 1e3 / step_ms
    result = {
        "phase": "train", "device": device_name, "nvidia_smi": smi,
        "model": "BasicNet MODEL_18_POINTS_PER_WING filters 64, bf16 compute over "
                 "float32 parameters, dropout 0.5, Adam 1e-3, batch 8, augmentation "
                 "(rotation 30, shifts 10, both flips, order 1, separable warp on "
                 "rotation buckets, Catmull-Rom passes), 192x192x4 -> 18",
        "samples": n, "val_samples": len(ds.val_inds), "dataset_seconds": t_data,
        "timed_steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP,
        "step_ms": step_ms, "steps_per_s": steps_per_s,
        "frames_per_s": steps_per_s * frames_per_step,
        "peak_memory_gib": peak_gib,
        "losses": losses.tolist(),
        "float32_card_vs_cpu": {
            "loss_rel_err": loss_err, "loss_rtol": TRAIN_LOSS_RTOL,
            "grad_err_of_max": grad_err, "grad_rtol": TRAIN_GRAD_RTOL,
            "param_max_abs_err": param_err, "param_beyond_gradients": unexplained,
            "param_atol": TRAIN_PARAM_ATOL,
            "sign_flips": flips},
        "resume": {"steps": list(RESUME_STEPS), "losses": whole_losses, "equal": True},
        "warp": warp, "step_ms_by_method": by_method,
        "eval": {"val_mse": float(np.mean(mses)), "val_l2_mean_px": float(l2s.mean())},
        "served": {"launches": launches, "encoder_convs_by_kernel": convs,
                   "decoder_convs_by_kernel": decoder_convs,
                   "decoder_up2_by_kernel": decoder_up2,
                   "max_abs_err": serve_err, "max_abs_maps": top, "rtol": ROUTE_RTOL},
    }
    result["seconds"] = time.perf_counter() - t_phase
    emit(result)
    return result


def warp_timings(torch, cfg, box) -> dict:
    """The warp alone at batch 8 and 256 on the step's bf16 frames: each
    call draws its bucket and matrices as the step does, then runs the
    separable warp on that bucket's canvas and the gather warp on the same
    matrices, in turns, each timed by CUDA events from an idle card; then
    the separable warp in float32 on the card against the CPU, each bucket."""
    from pose_estimation_amitai_torch.ops import affine

    buckets = affine.rotation_buckets(cfg.rotation_range, cfg.shear_range)
    check(buckets is not None and len(buckets) == 3, f"buckets {buckets}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def draw(images, bucket=None):
        if bucket is None:
            low, high, quad, limit = affine._draw_plan(
                gen, images, "separable", cfg.rotation_range, cfg.shear_range)
        else:
            low, high, quad = bucket
            limit = affine._shear_limit(high, cfg.shear_range)
        p = affine.sample_augment_params(
            gen, images.shape[0], rotation_range=high, xy_shifts=cfg.xy_shifts,
            zoom_range=cfg.zoom_range, do_horizontal_flip=cfg.horizontal_flip,
            do_vertical_flip=cfg.vertical_flip, shear_range=cfg.shear_range,
            rotation_low=low, quadrants=quad)
        mats = affine.make_affine_matrix(p, *images.shape[1:3])
        return buckets.index((low, high, quad)), mats, limit

    result = {}
    for batch, calls in WARP_CALLS.items():
        images = box[torch.arange(batch, device="cuda") % box.shape[0]].to(torch.bfloat16)
        ms, taken = {"separable": [], "exact": []}, []
        for i in range(WARP_WARMUP + calls):
            bucket, mats, limit = draw(images)
            run = {"separable": lambda: affine.affine_warp_separable_batch(
                       images, mats, 1, shear_limit=limit),
                   "exact": lambda: affine.affine_warp_batch(images, mats, 1)}
            for method in (("separable", "exact") if i % 2 == 0 else ("exact", "separable")):
                torch.cuda.synchronize()
                start.record()
                out = run[method]()
                end.record()
                end.synchronize()
                check(out.shape == images.shape and out.dtype == torch.bfloat16,
                      f"{method} warp gave {tuple(out.shape)} {out.dtype}")
                if i >= WARP_WARMUP:
                    ms[method].append(start.elapsed_time(end))
            if i >= WARP_WARMUP:
                taken.append(bucket)
        check(sorted(set(taken)) == [0, 1, 2], f"batch {batch}: buckets taken {taken}")
        result[f"batch_{batch}"] = {
            "separable_ms": float(np.mean(ms["separable"])),
            "exact_ms": float(np.mean(ms["exact"])),
            "separable_ms_by_bucket": [float(np.mean([t for t, k in zip(ms["separable"], taken)
                                                      if k == b])) for b in range(3)],
            "buckets_taken": taken}
    errs = []
    images = box[: cfg.batch_size].float()
    for bucket in buckets:
        _, mats, limit = draw(images, bucket)
        got = affine.affine_warp_separable_batch(images, mats, 1, shear_limit=limit)
        want = affine.affine_warp_separable_batch(images.cpu(), mats.cpu(), 1,
                                                  shear_limit=limit)
        check(bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.5,
              "the separable warp gave non-finite or empty frames")
        errs.append(float((got.cpu() - want).abs().max()))
    check(max(errs) <= WARP_F32_ATOL,
          f"separable warp card vs CPU, float32: {errs} > {WARP_F32_ATOL}")
    result["float32_card_vs_cpu_max_abs_err"] = errs
    result["float32_atol"] = WARP_F32_ATOL
    return result


def step_ms_by_method(torch, step, state, ds, cfg) -> dict:
    """ms a step at Config() with the separable warp (the default) and with
    the gather warp, in blocks of STEP_BLOCK steps timed by CUDA events:
    separable, gather, gather, separable, after a warm-up of each."""
    import functools

    from pose_estimation_amitai_torch.ops import affine

    real = affine.augment_views_and_peaks
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = {"separable": [], "exact": []}
    try:
        for block, method in enumerate(("separable", "exact", "exact", "separable")):
            affine.augment_views_and_peaks = functools.partial(real, method=method)
            if block < 2:
                for _ in range(TRAIN_WARMUP):
                    state, _ = step(state, ds.data,
                                    ds.step_indices(cfg.batch_size, cfg.accumulation_steps))
            idx = [ds.step_indices(cfg.batch_size, cfg.accumulation_steps)
                   for _ in range(STEP_BLOCK)]
            torch.cuda.synchronize()
            start.record()
            for i in range(STEP_BLOCK):
                state, loss = step(state, ds.data, idx[i])
            end.record()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(loss)), f"{method} warp: non-finite loss")
            ms[method].append(start.elapsed_time(end) / STEP_BLOCK)
    finally:
        affine.augment_views_and_peaks = real
    return {m: float(np.mean(v)) for m, v in ms.items()}


def phase_trainer(torch, device_name: str, smi: str, step_ms: float) -> dict:
    """The Trainer at Config() through a run and a resume on the card; its
    run directory served through the encoder-stage and decoder kernels."""
    import os
    import tempfile

    from pose_estimation_amitai_torch import Config, viz
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.train.trainer import LOSSES_HEADER, RUN_SUBFOLDERS, Trainer

    t_phase = time.perf_counter()
    arrays = train_arrays()
    k = TRAIN_POINTS // 2 + 2
    with tempfile.TemporaryDirectory() as out:
        cfg = Config(base_output_path=out, epochs=TRAINER_EPOCHS[0],
                     batches_per_epoch=TRAINER_UPDATES)
        t0 = time.perf_counter()
        tr = Trainer(cfg, arrays=arrays, device="cuda")
        t_init = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = tr.train()
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        steps = TRAINER_EPOCHS[0] * TRAINER_UPDATES
        check(tr.state.step == steps, f"the trainer took {tr.state.step} steps, not {steps}")
        check(len(history["train_loss"]) == TRAINER_EPOCHS[0]
              and bool(np.isfinite(history["train_loss"] + history["val_loss"]
                                   + history["l2"]).all()), f"history {history}")
        val_ms = []
        for _ in range(VAL_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.evaluate()
            torch.cuda.synchronize()
            val_ms.append((time.perf_counter() - t0) * 1e3)

        # the run directory: JAX's artifacts with .pt for .msgpack
        rp = tr.run_path
        files = sorted(os.listdir(rp))
        want = {"configuration.json", "losses.csv", "history.csv", "history.mat",
                "checkpoint.pt", "checkpoint_meta.json", "best_model.pt", "initial_model.pt",
                "final_confmaps_model.pt", "training code", *RUN_SUBFOLDERS}
        check(want <= set(files), f"run directory lacks {sorted(want - set(files))}")
        with open(os.path.join(rp, "losses.csv")) as f:
            rows = [line.strip().split(",") for line in f]
        check(rows[0] == LOSSES_HEADER and len(rows) == 1 + TRAINER_EPOCHS[0],
              f"losses.csv {rows}")
        pngs = [f for _, _, fs in os.walk(rp) for f in fs if f.endswith(".png")]
        if viz.available():
            check(bool(pngs) and not tr.pngs_skipped, "matplotlib is there but no PNG")
        else:
            check(tr.pngs_skipped and not pngs, f"PNGs without matplotlib: {pngs}")

        # resume to the later epoch count
        tr2 = Trainer(cfg.replace(epochs=TRAINER_EPOCHS[1], resume_from=rp), arrays=arrays,
                      device="cuda")
        check(tr2.start_epoch == TRAINER_EPOCHS[0] and tr2.state.step == steps
              and len(tr2.state.opt_state["state"]) == len(tr2.state.params),
              f"resumed at epoch {tr2.start_epoch}, step {tr2.state.step}")
        history2 = tr2.train()
        check(len(history2["train_loss"]) == TRAINER_EPOCHS[1] - TRAINER_EPOCHS[0]
              and bool(np.isfinite(history2["train_loss"]).all())
              and tr2.state.step == TRAINER_EPOCHS[1] * TRAINER_UPDATES,
              f"resumed run {history2}, step {tr2.state.step}")

        # the resumed run directory, served through the kernels
        served_dir = tr2.run_path
        frames = torch.cat([tr.dataset.data["box"], tr.dataset.data["box"].flip(1)]).cpu().numpy()
        pred = Predictor.from_checkpoint(cfg, served_dir, (192, 192, 4), k, use_fused=True,
                                         device="cuda", chunk_size=CHUNK, return_heatmaps=True)
        check(pred.serving_path == "fused", f"serving_path {pred.serving_path}")
        pred(frames[:1])  # warm-up
        # ---- the served chunk: counters zeroed just before, read just after ----
        zero_conv_counters(hc, hd)
        maps, pts = pred(frames)
        launches = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                    "fused_decoder": hd.fused_decoder.launches}
        convs = dict(hc.fused_encoder_stage.convs_by_kernel)
        up2 = dict(hd.fused_decoder.up2_by_kernel)
        # -----------------------------------------------------------------------
        check(launches == {"fused_encoder_stage": 3, "fused_decoder": 1}
              and convs == {"fma": 0, "mma_c4": 1, "wgmma": 8} and up2 == {"fma": 0, "mma": 2},
              f"the run directory's chunk took {launches}, {convs}, {up2}")
        check(maps.shape == (len(frames), 192, 192, k) == (CHUNK, 192, 192, k)
              and bool(np.isfinite(pts).all()), f"served {maps.shape}")
        module = Predictor.from_checkpoint(cfg, served_dir, (192, 192, 4), k, device="cuda",
                                           chunk_size=CHUNK, return_heatmaps=True)
        check(module.serving_path == "module", f"serving_path {module.serving_path}")
        want_maps, _ = module(frames)
        top = float(np.abs(want_maps).max())
        serve_err = float(np.abs(maps - want_maps).max())
        check(serve_err <= ROUTE_RTOL * top,
              f"fused vs module on the run directory: {serve_err} > {ROUTE_RTOL} * {top}")
        served_file = os.path.basename(
            next(os.path.join(served_dir, n) for n in ("best_model.pt", "checkpoint.pt")
                 if os.path.isfile(os.path.join(served_dir, n))))

    epoch_ms = [s * 1e3 for s in history["epoch_seconds"]]
    loop_steps_per_s = steps / t_train
    result = {
        "phase": "trainer", "device": device_name, "nvidia_smi": smi,
        "model": "BasicNet MODEL_18_POINTS_PER_WING at Config(): filters 64, batch 8, "
                 "bf16 compute, augmentation, dropout 0.5, 192x192x4 -> 18",
        "epochs": list(TRAINER_EPOCHS), "updates_per_epoch": TRAINER_UPDATES,
        "init_seconds": t_init, "train_seconds": t_train,
        "loop_ms_per_epoch": t_train * 1e3 / TRAINER_EPOCHS[0],
        "epoch_ms": epoch_ms, "validation_ms": val_ms,
        "loop_steps_per_s": loop_steps_per_s,
        "train_phase_step_ms": step_ms, "train_phase_steps_per_s": 1e3 / step_ms,
        "epoch_ms_beyond_steps": float(np.mean(epoch_ms[1:])) - TRAINER_UPDATES * step_ms,
        "history": history, "resumed_history": history2,
        "resumed_at_epoch": TRAINER_EPOCHS[0], "pngs_skipped": tr.pngs_skipped,
        "run_files": files,
        "served": {"file": served_file, "launches": launches, "encoder_convs_by_kernel": convs,
                   "decoder_up2_by_kernel": up2, "max_abs_err_vs_module": serve_err,
                   "max_abs_maps": top, "rtol": ROUTE_RTOL},
        "seconds": time.perf_counter() - t_phase,
    }
    emit(result)
    return result


def reader_rates(tmp: str, frame: np.ndarray) -> dict:
    """GB/s of read_datasets and of np.fromfile on the same bytes of a
    256-frame uint8 box (random) from a warm page cache, timed in turns;
    MB/s of the reader's decode of one deflated chunk (``zlib.decompress``,
    which the reader calls once a chunk) on ``frame`` (one synthetic frame
    of one camera as uint8, deflate level 4 as h5py's gzip writes it)."""
    import os
    import zlib

    from pose_estimation_amitai_torch.data import h5

    box = np.random.default_rng(SEED).integers(0, 256, (READ_FRAMES, 4, 192, 192, 5),
                                              dtype=np.uint8)
    path = os.path.join(tmp, "box.h5")
    try:
        t0 = time.perf_counter()
        h5.write_datasets(path, {"box": box})
        write_s = time.perf_counter() - t0
        offset = os.path.getsize(path) - box.nbytes  # the writer puts the data last
        reader_s, fromfile_s = [], []
        for i in range(2 * READ_REPS + 1):  # the first read warms the page cache
            t0 = time.perf_counter()
            if i % 2:
                got = np.fromfile(path, np.uint8, box.size, offset=offset).reshape(box.shape)
            else:
                got = h5.read_datasets(path, ["box"])["box"]
            dt = time.perf_counter() - t0
            check(got.dtype == box.dtype and np.array_equal(got, box), "the box read back differs")
            if i:
                (fromfile_s if i % 2 else reader_s).append(dt)
            del got
    finally:
        if os.path.exists(path):
            os.remove(path)
    chunk = frame.tobytes()
    packed = zlib.compress(chunk, 4)
    chunk_s = []
    for _ in range(READ_REPS):
        t0 = time.perf_counter()
        raw = zlib.decompress(packed)  # the reader's step for each deflated chunk
        chunk_s.append(time.perf_counter() - t0)
        check(raw == chunk, "the deflated chunk decodes to other bytes")
    return {"bytes": int(box.nbytes), "write_s": write_s,
            "read_datasets_s": reader_s, "fromfile_s": fromfile_s,
            "read_datasets_gb_per_s": box.nbytes / min(reader_s) / 1e9,
            "fromfile_gb_per_s": box.nbytes / min(fromfile_s) / 1e9,
            "deflated_chunk": {"bytes": len(chunk), "deflated_bytes": len(packed),
                               "seconds": chunk_s,
                               "mb_per_s": len(chunk) / min(chunk_s) / 1e6}}


def phase_entry(torch, device_name: str, smi: str) -> dict:
    """The config-file entry points on the card: the contract file written
    and read by the port's own HDF5 writer and reader, the trainer's module
    entry point in a child process, ``cli eval`` and ``cli infer`` on its
    run directory, that run directory served on B1/B2; the reader's rate."""
    import contextlib
    import io
    import os
    import tempfile

    from pose_estimation_amitai_torch import Config, cli
    from pose_estimation_amitai_torch.data import write_synthetic_h5
    from pose_estimation_amitai_torch.data.h5 import read_datasets
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.train.trainer import LOSSES_HEADER, RUN_SUBFOLDERS

    t_phase = time.perf_counter()
    k = TRAIN_POINTS // 2 + 2
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as out:
        # (a) the contract file, MATLAB's transposed dialect, read back
        data = os.path.join(out, "data.h5")
        write_synthetic_h5(data, num_frames=TRAIN_FRAMES, num_points=TRAIN_POINTS,
                           image_size=192, seed=SEED)
        arrays = train_arrays()
        written = {"box": arrays["box"].T, "confmaps": arrays["confmaps"].T,
                   "points_3D": np.transpose(arrays["points_3D"], (2, 0, 1)),
                   "cropZone": arrays["cropZone"],
                   "cameras_dlt_array": arrays["cameras_dlt_array"].T}
        got = read_datasets(data, list(written))
        for name, want in written.items():
            check(got[name].dtype == want.dtype and got[name].shape == want.shape
                  and np.array_equal(got[name], want),
                  f"{name} read back as {got[name].dtype} {got[name].shape}")
        file_bytes = os.path.getsize(data)
        frame = (arrays["box"][0, 0] * 255).astype(np.uint8)  # for the reader's rates
        # the served chunk: each camera's frame with one wing's mask, and the flips
        box = arrays["box"].reshape(-1, 192, 192, 5)
        samples = np.concatenate([box[..., [0, 1, 2, 3]], box[..., [0, 1, 2, 4]]])
        frames = np.concatenate([samples, samples[:, ::-1]])
        del got, arrays, written, box, samples

        # (b) python -m ...train.trainer cfg.json: a child process, no --device
        runs = os.path.join(out, "runs")
        cfg = Config(data_path=data, base_output_path=runs, epochs=ENTRY_EPOCHS,
                     batches_per_epoch=ENTRY_UPDATES)
        cfg_path = os.path.join(out, "config.json")
        with open(cfg_path, "w") as f:
            json.dump({**cfg.to_dict(), "base output path": runs}, f)
        check(Config.from_json(cfg_path) == cfg, "the config did not round-trip its JSON")
        torch.cuda.empty_cache()  # the child's card memory
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "pose_estimation_amitai_torch.train.trainer", cfg_path],
            cwd=root, capture_output=True, text=True, timeout=ENTRY_TIMEOUT)
        t_child = time.perf_counter() - t0
        check(child.returncode == 0,
              f"the trainer's entry point exited {child.returncode}: {child.stderr[-3000:]}")
        check("training on cuda:0" in child.stdout.splitlines(),
              f"the child did not train on the card: {child.stdout[:2000]}")
        (run,) = os.listdir(runs)
        run = os.path.join(runs, run)
        files = sorted(os.listdir(run))
        want = {"configuration.json", "losses.csv", "history.csv", "history.mat",
                "checkpoint.pt", "checkpoint_meta.json", "best_model.pt", "initial_model.pt",
                "final_confmaps_model.pt", "training code", *RUN_SUBFOLDERS}
        check(want <= set(files), f"run directory lacks {sorted(want - set(files))}")
        with open(os.path.join(run, "losses.csv")) as f:
            rows = [line.strip().split(",") for line in f]
        check(rows[0] == LOSSES_HEADER and len(rows) == 1 + ENTRY_EPOCHS
              and all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:] if v),
              f"losses.csv {rows}")

        # (c) cli eval and cli infer on the default device
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            check(cli.main(["eval", cfg_path, run, data]) == 0, "cli eval failed")
        t_eval = time.perf_counter() - t0
        text = buf.getvalue()
        stats = json.loads(text[text.index("{"):])
        check(all(np.isfinite(stats[key]).all() for key in ("l2_mean", "l2_std", "l2_max",
                                                             "l2_per_point"))
              and len(stats["l2_per_point"]) == k, f"eval {stats}")
        npz = os.path.join(out, "predictions.npz")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli.main(["infer", cfg_path, run, data, npz, "--mat"]) == 0, "cli infer failed")
        t_infer = time.perf_counter() - t0
        pts = np.load(npz)["points_2d"]
        samples = 8 * TRAIN_FRAMES
        check(pts.shape == (samples, 3, k) and bool(np.isfinite(pts).all())
              and os.path.isfile(os.path.join(out, "predictions.mat")),
              f"infer wrote points_2d {pts.shape}")

        # (d) the run directory served through the kernels
        check(frames.shape == (CHUNK, 192, 192, 4), f"frames {frames.shape}")
        pred = Predictor.from_checkpoint(cfg, run, (192, 192, 4), k, use_fused=True,
                                         device="cuda", chunk_size=CHUNK, return_heatmaps=True)
        check(pred.serving_path == "fused", f"serving_path {pred.serving_path}")
        pred(frames[:1])  # warm-up
        # ---- the served chunk: counters zeroed just before, read just after ----
        zero_conv_counters(hc, hd)
        maps, peaks = pred(frames)
        launches = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                    "fused_decoder": hd.fused_decoder.launches}
        convs = dict(hc.fused_encoder_stage.convs_by_kernel)
        up2 = dict(hd.fused_decoder.up2_by_kernel)
        # -----------------------------------------------------------------------
        check(launches == {"fused_encoder_stage": 3, "fused_decoder": 1}
              and convs == {"fma": 0, "mma_c4": 1, "wgmma": 8} and up2 == {"fma": 0, "mma": 2},
              f"the entry point's run directory took {launches}, {convs}, {up2}")
        check(maps.shape == (CHUNK, 192, 192, k) and bool(np.isfinite(peaks).all()),
              f"served {maps.shape}")
        module = Predictor.from_checkpoint(cfg, run, (192, 192, 4), k, device="cuda",
                                           chunk_size=CHUNK, return_heatmaps=True)
        want_maps, _ = module(frames)
        top = float(np.abs(want_maps).max())
        serve_err = float(np.abs(maps - want_maps).max())
        check(serve_err <= ROUTE_RTOL * top,
              f"fused vs module on the entry point's run directory: {serve_err} > "
              f"{ROUTE_RTOL} * {top}")
        del pred, module, maps, want_maps, frames

        # (e) the reader's rate at a real file size
        rates = reader_rates(out, frame)

    result = {
        "phase": "entry", "device": device_name, "nvidia_smi": smi,
        "model": "BasicNet MODEL_18_POINTS_PER_WING at Config(): filters 64, batch 8, "
                 "bf16 compute, augmentation, dropout 0.5, 192x192x4 -> 18",
        "data_file_bytes": file_bytes, "epochs": ENTRY_EPOCHS,
        "updates_per_epoch": ENTRY_UPDATES, "run_files": files,
        "child_seconds": t_child, "eval_seconds": t_eval, "infer_seconds": t_infer,
        "eval": {key: stats[key] for key in ("l2_mean", "l2_std", "l2_max")},
        "infer_points_2d": list(pts.shape),
        "served": {"launches": launches, "encoder_convs_by_kernel": convs,
                   "decoder_up2_by_kernel": up2, "max_abs_err_vs_module": serve_err,
                   "max_abs_maps": top, "rtol": ROUTE_RTOL},
        "reader": rates,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(result)
    print(f"entry phase: {result['seconds']:.1f} s (child {t_child:.1f} s, eval {t_eval:.1f} s, "
          f"infer {t_infer:.1f} s); reader {rates['read_datasets_gb_per_s']:.2f} GB/s, "
          f"np.fromfile {rates['fromfile_gb_per_s']:.2f} GB/s, a deflated chunk "
          f"{rates['deflated_chunk']['mb_per_s']:.0f} MB/s", flush=True)
    return result


def top_two_gap(maps: np.ndarray) -> np.ndarray:
    """(N, K) gap between each map's largest and second largest values."""
    flat = maps.reshape(maps.shape[0], -1, maps.shape[-1])
    top2 = np.partition(flat, -2, axis=1)[:, -2:, :]
    return top2[:, 1, :] - top2[:, 0, :]


def phase_multicam(torch, device_name: str, smi: str) -> dict:
    """MultiCamNet at full width through the Trainer; its run directory
    served folded and unfolded; one forward of each other new model."""
    import tempfile

    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.ops.peaks import find_peaks
    from pose_estimation_amitai_torch.train import loop
    from pose_estimation_amitai_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    arrays = train_arrays()
    shape, k = (192, 192, 16), 4 * (TRAIN_POINTS // 2 + 2)
    with tempfile.TemporaryDirectory() as out:
        cfg = Config(model_type=C.ALL_CAMS_18_POINTS, base_output_path=out,
                     epochs=MULTICAM_EPOCHS, batches_per_epoch=MULTICAM_UPDATES)
        tr = Trainer(cfg, arrays=arrays, device="cuda")
        check(tuple(tr.dataset.data["box"].shape[1:]) == shape
              and tr.dataset.data["confmaps"].shape[-1] == k,
              f"multicam samples {tuple(tr.dataset.data['box'].shape)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = tr.train()
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        check(tr.state.step == MULTICAM_EPOCHS * MULTICAM_UPDATES
              and bool(np.isfinite(history["train_loss"] + history["val_loss"]).all()),
              f"multicam history {history}")
        box = tr.dataset.data["box"]
        frames = torch.cat([box, box.flip(1)])[:MULTICAM_FRAMES].cpu().numpy()
        check(len(frames) == MULTICAM_FRAMES, f"{len(frames)} frames")

        routes = {}
        for dt in ("float32", "bfloat16"):
            for fold in (True, False):
                pred = Predictor.from_checkpoint(
                    cfg.replace(compute_dtype=dt), tr.run_path, shape, k, device="cuda",
                    chunk_size=MULTICAM_FRAMES, return_heatmaps=True)
                check(pred.serving_path == "module" and pred.model.fold_views,
                      f"multicam served on {pred.serving_path}")
                pred.model.fold_views = fold
                pred(frames[:1])  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                maps, pts = pred(frames)
                routes[(dt, fold)] = (maps, pts, (time.perf_counter() - t0) * 1e3)
                check(maps.shape == (MULTICAM_FRAMES, 192, 192, k)
                      and bool(np.isfinite(maps).all()), f"multicam maps {maps.shape}")
        served = {}
        for dt, rtol in (("float32", MULTICAM_F32_RTOL), ("bfloat16", MULTICAM_BF16_RTOL)):
            (a, pa, ms_f), (b, pb, ms_u) = routes[(dt, True)], routes[(dt, False)]
            top = float(np.abs(a).max())
            err = float(np.abs(a - b).max())
            check(err <= rtol * top, f"{dt}: folded vs unfolded {err} > {rtol} * {top}")
            clear = top_two_gap(a) > MULTICAM_GAP
            flips = int((np.any(pa[:, :2] != pb[:, :2], axis=1) & clear).sum())
            check(flips == 0, f"{dt}: {flips} argmax differ where the top-two gap > {MULTICAM_GAP}")
            served[dt] = {"max_abs_err": err, "max_abs_maps": top, "rtol": rtol,
                          "clear_maps": int(clear.sum()), "maps": int(clear.size),
                          "argmax_flips_where_clear": flips,
                          "folded_ms": ms_f, "unfolded_ms": ms_u}

        # one forward of each other new model, full width, batch 8
        forwards = {}
        zoo = [(C.TWO_WINGS_TOGATHER, {}, (192, 192, 5), 34),
               (C.C2F_PER_WING, {}, (192, 192, 4), 17),
               (C.ALL_CAMS_18_POINTS, {"arch_flavor": "tf", "do_attention": True}, shape, k)]
        for mt, extra, in_shape, out_k in zoo:
            zcfg = Config(model_type=mt, **extra)
            with torch.device("meta"):
                model = build_model(zcfg, in_shape, out_k)
            state = loop.create_train_state(model, zcfg, seed=SEED, device="cuda")
            x = torch.rand((ZOO_BATCH, *in_shape), generator=torch.Generator(device="cuda")
                           .manual_seed(SEED), device="cuda")
            y = loop.make_predict_fn(model)(state.params, x)
            check(tuple(y.shape) == (ZOO_BATCH, *in_shape[:2], out_k)
                  and y.dtype == torch.float32 and bool(torch.isfinite(y).all()),
                  f"{type(model).__name__}: {tuple(y.shape)}")
            forwards[f"{type(model).__name__} {mt} {zcfg.arch_flavor}"] = {
                "in": list(in_shape), "out": list(y.shape),
                "peaks": list(find_peaks(y).shape)}

    result = {
        "phase": "multicam", "device": device_name, "nvidia_smi": smi,
        "model": "MultiCamNet ALL_CAMS_18_POINTS torch flavour, filters 64, batch 8, bf16, "
                 "per-view augmentation, dropout 0.5, 192x192x16 -> 72",
        "epochs": MULTICAM_EPOCHS, "updates_per_epoch": MULTICAM_UPDATES,
        "train_seconds": t_train,
        "steps_per_s": MULTICAM_EPOCHS * MULTICAM_UPDATES / t_train,
        "epoch_ms": [s * 1e3 for s in history["epoch_seconds"]],
        "history": history, "served": served, "forwards": forwards,
        "seconds": time.perf_counter() - t_phase,
    }
    emit(result)
    return result


def card_vs_cpu_step(torch, model_type: str, data: dict, idx: np.ndarray,
                     shape: tuple, k: int) -> dict:
    """One float32 step (TF32 off, dropout 0, no augmentation, targets from
    the peaks) of ``model_type`` at Config()'s widths from the same seeded
    state on the card and on the CPU, under deterministic cuDNN: the loss,
    the gradients (of the model's largest: a conv bias in front of a
    train-mode BatchNorm has an exact gradient of 0, so its own largest is
    float32 noise), the updated parameters beyond what the gradients'
    difference explains (Adam's first update is lr * g / (|g| + eps)), and
    the running averages of a BatchNorm model (of each tensor's largest)."""
    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import loop

    cfg = Config(model_type=model_type, compute_dtype="float32", dropout_ratio=0.0,
                 do_augmentations=False)
    with torch.device("meta"):
        model = build_model(cfg, shape, k)
    grad_fn, step = loop.make_grad_fn(model, cfg), loop.make_train_step(model, cfg)
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for dev, d in (("cuda", data), ("cpu", {key: v.cpu() for key, v in data.items()})):
            st = loop.create_train_state(model, cfg, seed=SEED, device=dev)
            loss, grads = grad_fn(st.params, d, idx[0], torch.Generator(device=dev),
                                  st.batch_stats)
            new, step_loss = step(st, d, idx[:1])
            out[dev] = (float(loss), float(step_loss),
                        {key: g.cpu().numpy() for key, g in grads.items()},
                        {key: p.cpu().numpy() for key, p in new.params.items()},
                        {key: v.cpu().numpy() for key, v in new.batch_stats.items()})
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, slg, gg, pg, sg), (lc, slc, gc, pc, sc) = out["cuda"], out["cpu"]
    check(slg == lg and slc == lc, f"the step's loss is not its gradient's loss: card "
          f"{slg!r} vs {lg!r}, CPU {slc!r} vs {lc!r}")
    check(set(sg) == set(sc), f"running averages {sorted(sg)} vs {sorted(sc)}")
    top = max(float(np.abs(g).max()) for g in gc.values())
    grad_err, unexplained, flips = 0.0, 0.0, 0
    for key in gc:
        grad_err = max(grad_err, float(np.abs(gg[key] - gc[key]).max()) / top)
        same = np.sign(gg[key]) == np.sign(gc[key])
        flips += int((~same).sum())
        check(float(np.abs(gc[key][~same]).max(initial=0.0)) <= TRAIN_GRAD_RTOL * top,
              f"{model_type} {key}: a gradient sign differs away from zero")
        explained = cfg.learning_rate * ADAM_EPS * np.abs(gg[key] - gc[key]) / (
            (np.abs(gg[key]) + ADAM_EPS) * (np.abs(gc[key]) + ADAM_EPS))
        d = np.abs(pg[key] - pc[key])[same]
        unexplained = max(unexplained, float((d - explained[same]).max(initial=0.0)))
    stats_err = max((float(np.abs(sg[key] - sc[key]).max() / np.abs(sc[key]).max())
                     for key in sc), default=0.0)
    result = {"loss_rel_err": abs(lg - lc) / abs(lc), "loss_rtol": TRAIN_LOSS_RTOL,
              "grad_err_of_largest": grad_err, "grad_rtol": TRAIN_GRAD_RTOL,
              "param_beyond_gradients": unexplained, "param_atol": TRAIN_PARAM_ATOL,
              "stats_err_of_max": stats_err, "stats_rtol": ZOO_STATS_RTOL,
              "sign_flips": flips, "running_averages": len(sc)}
    check(result["loss_rel_err"] <= TRAIN_LOSS_RTOL, f"{model_type} card vs CPU loss {lg} vs {lc}")
    check(grad_err <= TRAIN_GRAD_RTOL, f"{model_type} card vs CPU gradients: {grad_err}")
    check(unexplained <= TRAIN_PARAM_ATOL, f"{model_type} card vs CPU parameters: {unexplained}")
    check(stats_err <= ZOO_STATS_RTOL, f"{model_type} card vs CPU running averages: {stats_err}")
    return result


def bare_steps(torch, step, state, ds, cfg, warmup: int = ZOO_WARMUP,
               steps: int = ZOO_STEPS) -> tuple[object, float]:
    """(state, milliseconds a step) of ``warmup`` + ``steps`` steps on the
    dataset's ring, the timed ones by CUDA events."""
    idx = [ds.step_indices(cfg.batch_size, 1) for _ in range(warmup + steps)]
    losses = []
    for i in range(warmup):
        state, loss = step(state, ds.data, idx[i])
        losses.append(loss)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(warmup, warmup + steps):
        state, loss = step(state, ds.data, idx[i])
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(torch.stack(losses)).all()), "non-finite bare-step losses")
    return state, start.elapsed_time(end) / steps


def zoo_trainer(torch, cfg, arrays) -> tuple[object, dict]:
    """A Trainer run of ZOO_EPOCHS x ZOO_UPDATES at batch 8 on the card and
    its bare step: (trainer, numbers)."""
    from pose_estimation_amitai_torch.train.trainer import Trainer

    tr = Trainer(cfg, arrays={key: v.copy() for key, v in arrays.items()}, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = tr.train()
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    steps = ZOO_EPOCHS * ZOO_UPDATES
    check(tr.state.step == steps and bool(np.isfinite(history["train_loss"]
                                                      + history["val_loss"]).all()),
          f"{cfg.model_type}: step {tr.state.step}, history {history}")
    check(tr.state.batch_stats and all(v.is_cuda and v.dtype == torch.float32
                                       for v in tr.state.batch_stats.values()),
          f"{cfg.model_type}: running averages not float32 on the card")
    _, step_ms = bare_steps(torch, tr.train_step, tr.state, tr.dataset, cfg)
    return tr, {"loop_steps_per_s": steps / t_train, "train_seconds": t_train,
                "epoch_ms": [x * 1e3 for x in history["epoch_seconds"]],
                "history": history, "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
                "frames_per_s": 1e3 / step_ms * cfg.batch_size}


def zoo_serve(pred, frames) -> dict:
    """The requests and the movie through ``pred``: equal peaks, and the
    rates."""
    pred(frames[:1])  # warm-up
    answers, movie, t_req, t_movie = serve(pred, frames)
    check_peaks(answers, movie, len(frames), pred.num_output_channels)
    return {"serving_path": pred.serving_path, "frames": len(frames),
            "requests": list(REQUESTS), "requests_frames_per_s": len(frames) / t_req,
            "movie_frames_per_s": len(frames) / t_movie, "movie_equals_requests": True}


def zoo_serve_ftl_fused(torch, cfg, run_path: str, kc: int, samples, cams, module_pts) -> dict:
    """The trained disentanglement model on the ``fused`` route: its rate
    beside the module's, the launches a chunk (B1 three, the ``ftl_fusion``
    kernel one and its "gemm" composition none, B2 one; the kernel's weights
    packed in the warm-up and not again), predict_movie equal to the requests, the share of peaks
    where the module's are, and the maps of ZOO_FTL_MAPS samples (a whole
    chunk: every row of its kernel calls) within ZOO_FTL_SHARE of the
    largest value from the module route's in float32 (TF32 off), beside
    the bf16 module route's gap from them."""
    import dataclasses

    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import ftl_fusion as ff
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.ops import hopper_ftl

    def build(c=cfg, chunk=CHUNK, **kw):
        return Predictor.from_checkpoint(c, run_path, (192, 192, 16), kc, device="cuda",
                                         chunk_size=chunk, cameras=cams, **kw)

    pred = build(use_fused=True)
    check(pred.serving_path == "fused", f"camera model on {pred.serving_path!r}")
    pred(samples[:1])  # warm-up
    torch.cuda.synchronize()
    counters = (lambda: (hc.fused_encoder_stage.launches, ff.ftl_fusion.launches,
                         hopper_ftl.ftl_fusion_kernel.launches, hd.fused_decoder.launches,
                         hopper_ftl.packed_weights.launches))
    before = counters()
    t_serve = time.perf_counter()
    pts = pred(samples)
    t_serve = time.perf_counter() - t_serve
    chunks = -(-len(samples) // CHUNK)
    launches = dict(zip(("B1", "ftl_fusion_gemm", "ftl_fusion_kernel", "B2", "ftl_pack"),
                        (a - b for a, b in zip(counters(), before))))
    check(launches == {"B1": 3 * chunks, "ftl_fusion_gemm": 0, "ftl_fusion_kernel": chunks,
                       "B2": chunks, "ftl_pack": 0},
          f"fused camera model launches {launches} for {chunks} chunks")
    movie = pred.predict_movie(samples)
    check(np.array_equal(movie, pts), "fused camera model: predict_movie disagrees with __call__")
    same = float(np.mean(np.all(pts[:, :2] == module_pts[:, :2], axis=1)))
    del pred
    n = ZOO_FTL_MAPS
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    # the float32 reference a quarter chunk at a time (its rows are independent)
    want = build(f32, CHUNK // 4, return_heatmaps=True)(samples[:n])[0]
    scale = float(np.abs(want).max())
    gaps = {}
    for route, f in (("module", False), ("fused", True)):
        got = build(use_fused=f, return_heatmaps=True)(samples[:n])[0]
        gaps[route] = float(np.abs(got - want).max()) / scale
        del got
    check(gaps["fused"] <= ZOO_FTL_SHARE,
          f"fused camera model's maps {gaps['fused']:.4f} of max from float32's")
    del want
    return {"serving_path": "fused", "samples": len(samples),
            "samples_per_s": len(samples) / t_serve,
            "view_frames_per_s": 4 * len(samples) / t_serve, "launches": launches,
            "movie_equals_requests": True, "peaks_where_module_share": same,
            "maps_compared": n, "maps_gap_of_max_from_float32": gaps}


def phase_zoo(torch, device_name: str, smi: str) -> dict:
    """ResNetHeatmapNet and FourCamDisentangled through the Trainer,
    GPTResNet through the bare step, all at full width on the card, each
    served through Predictor on its running averages."""
    import tempfile

    from pose_estimation_amitai_torch import Config, weights
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.data import build_dataset
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import loop

    t_phase = time.perf_counter()
    arrays = train_arrays()
    k = TRAIN_POINTS // 2 + 2
    models = {}
    with tempfile.TemporaryDirectory() as out:
        common = dict(base_output_path=out, epochs=ZOO_EPOCHS, batches_per_epoch=ZOO_UPDATES)

        # (a) ResNetHeatmapNet through the Trainer, then served
        t0 = time.perf_counter()
        cfg = Config(model_type=C.RESNET_18_POINTS_PER_WING, **common)
        tr, res = zoo_trainer(torch, cfg, arrays)
        check(type(tr.model).__name__ == "ResNetHeatmapNet" and tr.model.flavor == "tpu"
              and len(tr.state.batch_stats) == 2 * 53, "ResNet50 tpu flavour, 53 BatchNorms")
        idx = tr.dataset.step_indices(cfg.batch_size, 1)
        res["float32_card_vs_cpu"] = card_vs_cpu_step(
            torch, cfg.model_type, tr.dataset.data, idx, (192, 192, 4), k)
        box = tr.dataset.data["box"].cpu().numpy()
        frames = np.concatenate([box] * (-(-sum(REQUESTS) // len(box))))[: sum(REQUESTS)]
        pred = Predictor.from_checkpoint(cfg, tr.run_path, (192, 192, 4), k, device="cuda",
                                         chunk_size=CHUNK)
        res["served"] = zoo_serve(pred, frames)
        res["seconds"] = time.perf_counter() - t0
        models["ResNetHeatmapNet"] = res
        del tr, pred

        # (b) GPTResNet: bare steps, then its variables served
        t0 = time.perf_counter()
        cfg = Config(model_type=C.GPTNET)
        ds, _ = build_dataset(cfg, {key: v.copy() for key, v in arrays.items()}, device="cuda")
        with torch.device("meta"):
            model = build_model(cfg, (192, 192, 4), k)
        state0 = loop.create_train_state(model, cfg, seed=SEED, device="cuda")
        step = loop.make_train_step(model, cfg)
        torch.cuda.synchronize()
        t_loop = time.perf_counter()
        state, step_ms = bare_steps(torch, step, state0, ds, cfg)
        t_loop = time.perf_counter() - t_loop
        moved = [n for n in state.batch_stats
                 if not torch.equal(state.batch_stats[n], state0.batch_stats[n])]
        check(len(moved) == len(state.batch_stats) == 2 * 32,
              f"GPTResNet: {len(moved)} of {len(state.batch_stats)} running averages moved")
        pred = Predictor(cfg, weights.state_dict_to_flax(state.params, model), (192, 192, 4), k,
                         device="cuda", chunk_size=CHUNK,
                         batch_stats=weights.batch_stats_to_flax(state.batch_stats))
        models["GPTResNet"] = {
            "host_steps_per_s_with_warmup": (ZOO_WARMUP + ZOO_STEPS) / t_loop,
            "step_ms": step_ms,
            "steps_per_s": 1e3 / step_ms, "frames_per_s": 1e3 / step_ms * cfg.batch_size,
            "served": zoo_serve(pred, frames), "seconds": time.perf_counter() - t0}
        del ds, state, state0, pred

        # (c) FourCamDisentangled through the Trainer, served with cameras
        t0 = time.perf_counter()
        cfg = Config(model_type=C.ALL_CAMS_DISENTANGLED_PER_WING_CNN, **common)
        check(cfg.do_augmentations and cfg.num_base_filters == 64, "Config()'s widths")
        tr, res = zoo_trainer(torch, cfg, arrays)
        data = tr.dataset.data
        n, kc = data["box"].shape[0], data["confmaps"].shape[-1]
        check(n == 2 * TRAIN_FRAMES and tuple(data["box"].shape[1:]) == (192, 192, 16)
              and kc == 4 * k and tuple(data["P"].shape) == (n, 4, 3, 4),
              f"disentangled samples {tuple(data['box'].shape)}, cameras {tuple(data['P'].shape)}")
        idx = tr.dataset.step_indices(cfg.batch_size, 1)
        res["float32_card_vs_cpu"] = card_vs_cpu_step(
            torch, cfg.model_type, data, idx, (192, 192, 16), kc)
        rows = np.arange(ZOO_SERVED) % n
        samples = data["box"].cpu().numpy()[rows]
        cams = (data["P"].cpu().numpy()[rows], data["P_inv"].cpu().numpy()[rows])
        pred = Predictor.from_checkpoint(cfg, tr.run_path, (192, 192, 16), kc, device="cuda",
                                         chunk_size=CHUNK, cameras=cams)
        pred(samples[:1])  # warm-up
        torch.cuda.synchronize()
        t_serve = time.perf_counter()
        pts = pred(samples)
        t_serve = time.perf_counter() - t_serve
        check(pts.shape == (ZOO_SERVED, 3, kc) and bool(np.isfinite(pts).all()),
              f"served {pts.shape}")
        tail = np.arange(CHUNK, ZOO_SERVED)
        differ = int(np.any(pts[tail, :2] != pts[tail % n, :2], axis=(1, 2)).sum())
        check(differ == 0, f"{differ} padded-tail samples decode other peaks than in a full chunk")
        res["served"] = {"serving_path": pred.serving_path, "samples": ZOO_SERVED,
                         "chunks": [CHUNK, ZOO_SERVED - CHUNK],
                         "samples_per_s": ZOO_SERVED / t_serve,
                         "view_frames_per_s": 4 * ZOO_SERVED / t_serve,
                         "tail_samples_differing": differ}
        res["served_fused"] = zoo_serve_ftl_fused(torch, cfg, tr.run_path, kc, samples, cams,
                                                  pts)
        res["seconds"] = time.perf_counter() - t0
        models["FourCamDisentangled"] = res
        del tr, pred

    result = {"phase": "zoo", "device": device_name, "nvidia_smi": smi,
              "model": "full width, bf16 compute over float32 parameters, batch 8, "
                       "16 synthetic 192x192 frames (seed 0): ResNetHeatmapNet tpu flavour "
                       "ResNet50 192x192x4 -> 18; GPTResNet 192x192x4 -> 18; "
                       "FourCamDisentangled filters 64 192x192x16 -> 72",
              "models": models, "seconds": time.perf_counter() - t_phase}
    emit(result)
    return result

def phase_vit_train(torch, device_name: str, smi: str) -> dict:
    """ViT training at full width through the Trainer on the card: the
    torch flavour's run (bare step and loop rates), one float32 step card
    vs CPU, the run directory served on the "fused" route (the attention
    kernel, its launches counted) against "module", one tf-flavour step with
    its 0.1 attention dropout live, and the 4-camera ViT through the
    Trainer."""
    import tempfile

    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models import build_model, vit
    from pose_estimation_amitai_torch.ops import hopper_attention as ha
    from pose_estimation_amitai_torch.train import loop
    from pose_estimation_amitai_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    arrays = train_arrays()
    k = TRAIN_POINTS // 2 + 2
    result = {"phase": "vit_train", "device": device_name, "nvidia_smi": smi,
              "model": "ViTPoseNet MODEL_18_POINTS_PER_WING_VIT patch 16 dim 256 depth 8 "
                       "heads 8 dim_head 256 mlp 1024, bf16 compute over float32 "
                       "parameters, batch 8, 128 per-wing samples of 192x192x4 -> 18"}
    with tempfile.TemporaryDirectory() as out:
        # (1) the torch flavour through the Trainer; its bare step
        cfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT, base_output_path=out,
                     epochs=VIT_TRAIN_EPOCHS, batches_per_epoch=VIT_TRAIN_UPDATES)
        check((cfg.projection_dim, cfg.transformer_layers, cfg.num_heads, cfg.patch_size,
               cfg.fully_connected_expand, bool(cfg.dim_head), cfg.batch_size,
               cfg.compute_dtype) == (256, 8, 8, 16, 4, True, 8, "bfloat16"),
              "Config() ViT defaults changed")
        tr = Trainer(cfg, arrays={key: v.copy() for key, v in arrays.items()}, device="cuda")
        check(type(tr.model).__name__ == "ViTPoseNet", type(tr.model).__name__)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = tr.train()
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        steps = VIT_TRAIN_EPOCHS * VIT_TRAIN_UPDATES
        check(tr.state.step == steps and bool(np.isfinite(history["train_loss"]
                                                          + history["val_loss"]).all()),
              f"ViT: step {tr.state.step}, history {history}")
        _, step_ms = bare_steps(torch, tr.train_step, tr.state, tr.dataset, cfg,
                                VIT_TRAIN_WARMUP, VIT_TRAIN_STEPS)
        result["torch_flavour"] = {
            "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
            "frames_per_s": 1e3 / step_ms * cfg.batch_size,
            "loop_steps_per_s": steps / t_train, "train_seconds": t_train,
            "epoch_ms": [x * 1e3 for x in history["epoch_seconds"]], "history": history}

        # (2) one float32 step, card vs CPU (TF32 off)
        idx = tr.dataset.step_indices(cfg.batch_size, 1)
        result["float32_card_vs_cpu"] = card_vs_cpu_step(
            torch, cfg.model_type, tr.dataset.data, idx, (192, 192, 4), k)

        # (3) the run directory on "fused" (the attention kernel) and "module"
        box = tr.dataset.data["box"].cpu().numpy()
        check(len(box) <= CHUNK, f"{len(box)} samples: one chunk expected")

        def served(**kw):
            return Predictor.from_checkpoint(cfg, tr.run_path, (192, 192, 4), k,
                                             device="cuda", chunk_size=CHUNK,
                                             return_heatmaps=True, **kw)

        fused = served(use_fused=True)
        check(fused.serving_path == "fused" and fused.model.fused_attention,
              f"served on {fused.serving_path}")
        fused(box[:1])  # warm-up
        # ---- the served run directory: counter zeroed just before, read after
        ha.fused_attention.launches = 0
        ha.fused_attention.launches_by_kernel = dict.fromkeys(ha.KERNEL_CODES, 0)
        fm, fp = fused(box)
        launches = ha.fused_attention.launches
        by_kernel = dict(ha.fused_attention.launches_by_kernel)
        # ----------------------------------------------------------------------
        check(launches == cfg.transformer_layers,
              f"the served run directory launched the attention kernel {launches} times, "
              f"expected {cfg.transformer_layers} (one chunk)")
        check(by_kernel["mma"] == launches, f"attention launches by kernel {by_kernel}")
        module = served()
        check(module.serving_path == "module", module.serving_path)
        mm, mp = module(box)
        result["served"] = {
            "samples": len(box), "launches": {"fused_attention": launches},
            "attention_launches_by_kernel": by_kernel,
            "fused_vs_module": compare_routes(torch, (fm, fp), (mm, mp),
                                              ROUTE_RTOL * float(np.abs(mm).max()),
                                              "vit_train bfloat16")}
        del fused, module, fm, mm

        # (4) one tf-flavour step: the fixed 0.1 attention dropout is live
        cfg_tf = cfg.replace(arch_flavor="tf")
        with torch.device("meta"):
            model_tf = build_model(cfg_tf, (192, 192, 4), k)
        state_tf = loop.create_train_state(model_tf, cfg_tf, seed=SEED, device="cuda")
        kept = [0, 0]
        real_drop = vit.drop

        def counting_drop(x, rate, generator):
            y = real_drop(x, rate, generator)
            if rate == vit.TF_ATTENTION_DROPOUT:
                live = x != 0
                kept[0] += int((y != 0)[live].sum())
                kept[1] += int(live.sum())
            return y

        vit.drop = counting_drop
        try:
            t0 = time.perf_counter()
            new_tf, loss_tf = loop.make_train_step(model_tf, cfg_tf)(
                state_tf, tr.dataset.data, tr.dataset.step_indices(cfg.batch_size, 1))
            torch.cuda.synchronize()
            t_tf = time.perf_counter() - t0
        finally:
            vit.drop = real_drop
        share = kept[0] / max(kept[1], 1)
        check(kept[1] > 0 and abs(share - 0.9) <= TF_DROPOUT_KEEP_ATOL,
              f"tf flavour: {share} of the attention probabilities kept, expected 0.9")
        check(bool(torch.isfinite(loss_tf)), f"tf flavour loss {loss_tf}")
        result["tf_flavour_step"] = {"kept_share": share, "probabilities": kept[1],
                                     "kept_atol": TF_DROPOUT_KEEP_ATOL,
                                     "loss": float(loss_tf), "host_seconds": t_tf}
        del new_tf, state_tf
        del tr

        # (5) the 4-camera ViT through the Trainer
        cfg4 = Config(model_type=C.ALL_CAMS_18_POINTS_VIT, base_output_path=out, epochs=1,
                      batches_per_epoch=VIT4_TRAIN_UPDATES)
        tr4 = Trainer(cfg4, arrays={key: v.copy() for key, v in arrays.items()}, device="cuda")
        check(type(tr4.model).__name__ == "ViT4Cameras"
              and tuple(tr4.dataset.data["box"].shape[1:]) == (192, 192, 16),
              f"4-camera ViT samples {tuple(tr4.dataset.data['box'].shape)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history4 = tr4.train()
        torch.cuda.synchronize()
        t4 = time.perf_counter() - t0
        check(tr4.state.step == VIT4_TRAIN_UPDATES
              and bool(np.isfinite(history4["train_loss"] + history4["val_loss"]).all()),
              f"4-camera ViT: step {tr4.state.step}, history {history4}")
        _, step4_ms = bare_steps(torch, tr4.train_step, tr4.state, tr4.dataset, cfg4,
                                 VIT4_TRAIN_WARMUP, VIT4_TRAIN_STEPS)
        result["four_cameras"] = {
            "model": "ViT4Cameras ALL_CAMS_18_POINTS_VIT, 4 fusion blocks (dim 1280, heads 4), "
                     "192x192x16 -> 72, batch 8, 4 augmentation transforms a sample",
            "step_ms": step4_ms, "steps_per_s": 1e3 / step4_ms,
            "loop_steps_per_s": VIT4_TRAIN_UPDATES / t4, "history": history4}
        del tr4
    result["launches"] = result["served"]["launches"]
    result["seconds"] = time.perf_counter() - t_phase
    emit(result)
    return result


def int8_generic_case(torch, name: str, cfg, params, stats, frames, cams, k: int,
                      chunk: int, quantized_layers: str | None, switches: dict) -> dict:
    """One model on "int8_generic": served on the card (requests and movie),
    against its bf16 module route's peaks; then, on a small chunk, the
    calibration scales card vs CPU (float32 compute, TF32 off), each
    quantised layer's output card vs CPU on the same input (bit-equal: the
    sums of int8 products are exact), and the maps card vs CPU."""
    from pose_estimation_amitai_torch import weights
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.models import quantized_generic as qg

    t_case = time.perf_counter()
    shape, n = frames.shape[1:], len(frames)
    common = dict(device="cuda", chunk_size=chunk, batch_stats=stats, cameras=cams)
    t0 = time.perf_counter()
    pred = Predictor(cfg, params, shape, k, use_quantized=True,
                     calibration_frames=frames[:INT8G_CALIB], quantized_layers=quantized_layers,
                     **common)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(pred.serving_path == "int8_generic", f"{name}: served on {pred.serving_path}")
    pred(frames[:1])  # warm-up
    if cams is None:
        answers, movie, t_req, t_movie = serve(pred, frames)
    else:
        # the camera rows are those of the frames one call is given: the
        # samples go in one call, as a movie does (zoo phase)
        t0 = time.perf_counter()
        answers = [pred(frames)]
        t_req = time.perf_counter() - t0
        t0 = time.perf_counter()
        movie = pred.predict_movie(frames)
        t_movie = time.perf_counter() - t0
    peaks = check_peaks(answers, movie, n, k)
    del pred
    module = Predictor(cfg, params, shape, k, **common)
    check(module.serving_path == "module", f"{name}: bf16 route {module.serving_path}")
    module(frames[:1])
    t0 = time.perf_counter()
    bf16 = module(frames)
    t_module = time.perf_counter() - t0
    del module
    dist = np.linalg.norm(peaks[:, :2] - bf16[:, :2], axis=1)
    torch.cuda.empty_cache()

    # held on a small chunk: card against CPU
    small = [frames[:INT8G_CHECK]] + ([c[:INT8G_CHECK] for c in cams] if cams else [])
    flt = qg.conv_layers_only if quantized_layers == "conv_only" else None

    def model_on(c, dev):
        with torch.device("meta"):
            m = build_model(c, shape, k, **switches)
        state = {key: v.to(dev, torch.float32) for key, v in
                 weights.flax_to_state_dict(params, m, stats or {}).items()}
        m = m.to_empty(device=dev).eval()
        m.load_state_dict(state)
        return m, state, [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in small]

    scales = {}
    for dev in ("cuda", "cpu"):
        m, state, inputs = model_on(cfg.replace(compute_dtype="float32"), dev)
        scales[dev] = qg.calibrate_apply(m, state, [tuple(inputs)], flt)
    check(sorted(scales["cuda"]) == sorted(scales["cpu"]) and scales["cpu"],
          f"{name}: calibrated layers differ card vs CPU")
    scale_err = max(abs(scales["cuda"][key] - v) / v for key, v in scales["cpu"].items())
    check(scale_err <= INT8G_SCALE_RTOL, f"{name}: calibration scales card vs CPU {scale_err}")

    seen: dict = {}
    outs, layers = {}, {}
    sc = None  # the CPU's scales of the served (bf16) model, given to both
    for dev in ("cpu", "cuda"):
        m, state, inputs = model_on(cfg, dev)
        if sc is None:
            sc = qg.calibrate_apply(m, state, [tuple(inputs)], flt)
        qm = qg.quantize_model(m, state, sc)
        layers[dev] = {path: mod for path, mod in qm.named_modules()
                       if isinstance(mod, qg.QuantizedLayer)}
        handles = []
        if dev == "cpu":
            for path, mod in layers[dev].items():
                handles.append(mod.register_forward_hook(
                    lambda mod, args, out, path=path: seen.setdefault(path, []).append(
                        (args[0], out))))
        with torch.no_grad():
            outs[dev] = qm(*inputs).float().cpu()
        for h in handles:
            h.remove()
    check(set(seen) == set(layers["cuda"]) and len(seen) == len(sc),
          f"{name}: {len(seen)} quantised layers ran of {len(sc)}")
    unequal = 0
    with torch.no_grad():
        for path, calls in seen.items():
            for x, want in calls:
                got = layers["cuda"][path](x.to("cuda")).cpu()
                unequal += int(not torch.equal(got, want))
    check(unequal == 0, f"{name}: {unequal} quantised layer calls differ card vs CPU")
    top = float(outs["cpu"].abs().max())
    maps_err = float((outs["cuda"] - outs["cpu"]).abs().max())
    check(bool(torch.isfinite(outs["cuda"]).all()) and maps_err <= INT8G_MAPS_RTOL * top,
          f"{name}: int8_generic maps card vs CPU {maps_err} > {INT8G_MAPS_RTOL} * {top}")
    return {
        "model": name, "quantized_layers": quantized_layers or "all", "chunk_size": chunk,
        "quantised_layers": len(sc), "calibration_frames": INT8G_CALIB,
        "build_seconds": t_build, "requests": list(REQUESTS) if cams is None else [n],
        "frames_per_s": n / t_req, "movie_frames_per_s": n / t_movie,
        "module_bf16_frames_per_s": n / t_module,
        "median_peak_px_vs_bf16_module": float(np.median(dist)),
        "mean_peak_px_vs_bf16_module": float(dist.mean()),
        "card_vs_cpu": {"frames": INT8G_CHECK, "scale_max_rel_err": scale_err,
                        "scale_rtol": INT8G_SCALE_RTOL,
                        "layer_calls_bit_equal": sum(len(c) for c in seen.values()),
                        "maps_max_abs_err": maps_err, "maps_max_abs": top,
                        "maps_rtol": INT8G_MAPS_RTOL,
                        "maps_equal_share": float((outs["cuda"] == outs["cpu"])
                                                  .float().mean())},
        "seconds": time.perf_counter() - t_case}


def phase_int8_generic(torch, frames, device_name: str, smi: str) -> dict:
    """"int8_generic" at full width on seeded weights, calibrated on 32
    frames, serving the 612-frame requests and movie: the ViT ('all' and
    'conv_only'), MultiCamNet, ResNetHeatmapNet (its running averages) and
    FourCamDisentangled (its cameras)."""
    from pose_estimation_amitai_torch import Config, weights
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.models import build_model
    from pose_estimation_amitai_torch.train import loop

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    views = np.concatenate([frames, frames[::-1], frames[:, ::-1], frames[:, :, ::-1]],
                           axis=-1)  # 612 x 192 x 192 x 16, four views
    P = rng.standard_normal((len(frames), 4, 3, 4))
    P /= np.linalg.norm(P, axis=(-2, -1), keepdims=True)
    P_inv = np.linalg.pinv(P)
    P_inv /= np.linalg.norm(P_inv, axis=(-2, -1), keepdims=True)
    cams = (P.astype(np.float32), P_inv.astype(np.float32))

    def seeded(cfg, shape, k):
        """flax params and batch_stats of ``create_train_state``'s seeded init."""
        with torch.device("meta"):
            model = build_model(cfg, shape, k)
        state = loop.create_train_state(model, cfg, seed=SEED, device="cpu")
        stats = weights.batch_stats_to_flax(state.batch_stats) if state.batch_stats else None
        return weights.state_dict_to_flax(state.params, model), stats

    vit_cfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT)
    vit_p = vit_params(vit_cfg, 4, 18, four=False)
    # the ViT as the Predictor serves argmax peaks: raw maps, bf16 softmax chain
    vit_switches = {"normalize_output": False, "fast_softmax": True}
    cases = []
    for layers in ("all", "conv_only"):
        cases.append((f"ViTPoseNet {layers}", vit_cfg, vit_p, None, frames, None, 18, CHUNK,
                      layers, vit_switches))
    cfg = Config(model_type=C.ALL_CAMS_18_POINTS)
    cases.append(("MultiCamNet", cfg, *seeded(cfg, views.shape[1:], 72), views, None, 72,
                  INT8G_CHUNK_4CAM, None, {}))
    cfg = Config(model_type=C.RESNET_18_POINTS_PER_WING)
    cases.append(("ResNetHeatmapNet", cfg, *seeded(cfg, frames.shape[1:], 18), frames, None,
                  18, CHUNK, None, {}))
    cfg = Config(model_type=C.ALL_CAMS_DISENTANGLED_PER_WING_CNN)
    cases.append(("FourCamDisentangled", cfg, *seeded(cfg, views.shape[1:], 72), views, cams,
                  72, INT8G_CHUNK_4CAM, None, {}))
    models = [int8_generic_case(torch, *case) for case in cases]
    result = {"phase": "int8_generic", "device": device_name, "nvidia_smi": smi,
              "model": "full width, seeded weights, bf16 compute: ViTPoseNet (dim 256, depth "
                       "8) 192x192x4 -> 18; MultiCamNet ALL_CAMS_18_POINTS filters 64 and "
                       "FourCamDisentangled filters 64, 192x192x16 -> 72; ResNetHeatmapNet "
                       "tpu flavour ResNet50 192x192x4 -> 18",
              "frames": len(frames), "models": models,
              "seconds": time.perf_counter() - t_phase}
    emit(result)
    return result

# the selfsup phase: SelfSupTrainer at Config() on the train phase's boxes
SELFSUP_EPOCHS = 3
SELFSUP_UPDATES = 10
SELFSUP_WARMUP = 3  # bare steps before the timed ones
SELFSUP_STEPS = 10
SELFSUP_CHECK = 2  # crops of the float32 card-vs-CPU step
SELFSUP_FT_UPDATES = 5  # the fine-tuning Trainer: 1 epoch of these
# the import phase: reference-layout checkpoints at full width
IMPORT_F32_RTOL = 1e-4  # served maps vs the reference module's forward, float32, of max
IMPORT_BF16_RTOL = 5e-2  # the same in bf16
KERAS_CPU_FRAMES = 2  # the keras BasicNet's maps card vs CPU on these frames
# the export phase
EXPORT_GAP = 2e-4  # peaks equal wherever the top-two gap exceeds this
EXPORT_F32_RTOL = 1e-4  # float32 programs' peak values vs the Predictor's, of max
EXPORT_REPS = 2  # timed passes over the frames, program and Predictor in turns


def selfsup_crops(torch) -> np.ndarray:
    """The train phase's synthetic boxes as (N, 192, 192, 5) crops, one a
    camera view: 16 frames x 4 cameras."""

    box = train_arrays()["box"]
    return box.reshape(-1, *box.shape[2:])


def phase_selfsup(torch, device_name: str, smi: str) -> dict:
    """Self-supervised inpainting at Config() on the card; its run directory
    re-heads the Trainer's flagship and serves through the encoder-stage and
    decoder kernels."""
    import os
    import tempfile

    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models.cnn import BasicNet
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.train import selfsup
    from pose_estimation_amitai_torch.train.loop import _init_params
    from pose_estimation_amitai_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    crops = selfsup_crops(torch)
    with tempfile.TemporaryDirectory() as out:
        cfg = Config(base_output_path=out, epochs=SELFSUP_EPOCHS,
                     batches_per_epoch=SELFSUP_UPDATES)
        pre = selfsup.SelfSupTrainer(cfg, crops, device="cuda")
        check(pre.data.is_cuda and pre.state.params["encoder.conv1.weight"].is_cuda,
              "the pretrainer's data and state are not on the card")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = pre.train()
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        steps = SELFSUP_EPOCHS * SELFSUP_UPDATES
        val = history["val_loss"]
        check(pre.state.step == steps and bool(np.isfinite(history["train_loss"] + val).all()),
              f"pretraining {history}, step {pre.state.step}")
        check(val[-1] < val[0], f"validation loss did not fall: {val}")
        run = pre.run_path
        check({"best_model.pt", "checkpoint.pt"} <= set(os.listdir(run)),
              f"run directory {sorted(os.listdir(run))}")
        best = torch.load(os.path.join(run, "best_model.pt"), weights_only=True)["params"]

        # the bare step (CUDA events), on the trained state
        ids = [pre.train_inds[(s * cfg.batch_size + np.arange(cfg.batch_size))
                              % len(pre.train_inds)]
               for s in range(SELFSUP_WARMUP + SELFSUP_STEPS)]
        for i in ids[:SELFSUP_WARMUP]:
            pre.train_step(i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in ids[SELFSUP_WARMUP:]:
            pre.train_step(i)
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / SELFSUP_STEPS

        # one step, card vs CPU, on the same (holed, clean) crops, held in
        # float64: in float32 a few hundred max-pool and LeakyReLU near-ties
        # of these crops round the other way from one device (or precision)
        # to the other and move up to ~1e-3 of a tensor's largest gradient,
        # as far as the CPU's own float32 step lies from its float64 step
        # (both reported beside the check)
        f32 = cfg.replace(compute_dtype="float32", dropout_ratio=0.0)
        box = torch.from_numpy(crops[:SELFSUP_CHECK])
        holed, clean = selfsup.make_prepare(f32)(torch.Generator().manual_seed(SEED), box)
        # a hole is a constant patch, so the max-pools see exact ties there,
        # and cuDNN and the CPU route a tied window's gradient to different
        # (equally valid) elements: a little noise breaks the ties
        holed = holed + torch.rand(holed.shape, generator=torch.Generator().manual_seed(SEED)) * 1e-3
        by_dtype = {}
        for dt in (torch.float64, torch.float32):
            with torch.device("meta"):
                model = BasicNet(4, out_channels=4, filters=f32.num_base_filters,
                                 dropout=0.0, dtype=dt)
            params = {k: v.to(dt) for k, v in _init_params(model, SEED).items()}
            grads_fn = selfsup.make_loss_and_grads(model)
            cpu = grads_fn(params, holed.to(dt), clean.to(dt), torch.Generator())
            with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
                card = grads_fn({k: v.cuda() for k, v in params.items()}, holed.to(dt).cuda(),
                                clean.to(dt).cuda(), torch.Generator(device="cuda"))
            by_dtype[dt] = (cpu, card)

        def step_errs(a, b) -> tuple[float, float]:
            """(loss relative error, largest gradient error of its tensor's
            max) of step ``a`` against step ``b``."""
            (la, ga), (lb, gb) = a, b
            return (abs(float(la) - float(lb)) / abs(float(lb)),
                    max(float((ga[k].cpu().double() - gb[k].double()).abs().max())
                        / float(gb[k].abs().max()) for k in gb))

        loss_err, grad_err = step_errs(by_dtype[torch.float64][1], by_dtype[torch.float64][0])
        loss_err32, grad_err32 = step_errs(by_dtype[torch.float32][1], by_dtype[torch.float32][0])
        _, cpu32_grad_err = step_errs(by_dtype[torch.float32][0], by_dtype[torch.float64][0])
        check(loss_err <= TRAIN_LOSS_RTOL, f"selfsup f64 loss card vs CPU {loss_err}")
        check(grad_err <= TRAIN_GRAD_RTOL, f"selfsup f64 gradients card vs CPU {grad_err}")
        check(np.isfinite(loss_err32) and np.isfinite(grad_err32),
              "selfsup f32 step: non-finite loss or gradients")
        del by_dtype

        # the pretrained encoder re-heads the flagship in the Trainer
        arrays = train_arrays()
        ft = Trainer(Config(base_output_path=out, pretrained_encoder_path=run, epochs=1,
                            batches_per_epoch=SELFSUP_FT_UPDATES), arrays=arrays,
                     device="cuda")
        enc = [k for k in ft.state.params if k.startswith("encoder.")]
        check(len(enc) == 18 and all(torch.equal(ft.state.params[k].cpu(), best[k])
                                     for k in enc),
              "the fine-tuned encoder is not the pretrained one before its first step")
        ft_history = ft.train()
        check(ft.state.step == SELFSUP_FT_UPDATES
              and bool(np.isfinite(ft_history["train_loss"]).all()),
              f"fine-tuning {ft_history}")

        # the pretraining run directory served through the kernels
        frames = np.resize(crops[..., :4], (CHUNK, 192, 192, 4))
        pred = Predictor.from_checkpoint(Config(), run, (192, 192, 4), 4, use_fused=True,
                                         device="cuda", chunk_size=CHUNK)
        check(pred.serving_path == "fused", f"serving_path {pred.serving_path}")
        pred(frames[:1])  # warm-up
        # ---- the served chunk: counters zeroed just before, read just after ----
        zero_conv_counters(hc, hd)
        pts = pred(frames)
        launches = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                    "fused_decoder": hd.fused_decoder.launches}
        # -----------------------------------------------------------------------
        check(launches == {"fused_encoder_stage": 3, "fused_decoder": 1},
              f"the pretraining run directory's chunk took {launches}")
        check(pts.shape == (CHUNK, 3, 4) and bool(np.isfinite(pts).all()), f"served {pts.shape}")
    result = {
        "phase": "selfsup", "device": device_name, "nvidia_smi": smi,
        "model": "inpainting BasicNet at Config(): filters 64, 4 -> 4 channels, batch 8, "
                 "bf16 compute, augmentation, dropout 0.5, 192x192; 64 crops (16 frames x "
                 "4 cameras), half validation",
        "epochs": SELFSUP_EPOCHS, "updates_per_epoch": SELFSUP_UPDATES,
        "step_ms": step_ms, "loop_steps_per_s": steps / t_train, "train_seconds": t_train,
        "val_loss_first": val[0], "val_loss_last": val[-1], "history": history,
        "f64_card_vs_cpu": {"crops": SELFSUP_CHECK, "loss_rel_err": loss_err,
                            "grad_err_of_max": grad_err, "loss_rtol": TRAIN_LOSS_RTOL,
                            "grad_rtol": TRAIN_GRAD_RTOL},
        "f32_card_vs_cpu": {"loss_rel_err": loss_err32, "grad_err_of_max": grad_err32,
                            "cpu_f32_vs_f64_grad_err_of_max": cpu32_grad_err},
        "finetune": {"updates": SELFSUP_FT_UPDATES, "encoder_tensors": len(enc),
                     "history": ft_history},
        "served": {"launches": launches},
        "seconds": time.perf_counter() - t_phase,
    }
    emit(result)
    return result


def reference_modules(torch):
    """Reference-layout torch modules, state-dict compatible with the
    reference's checkpoints (pytorch/CNNs.py:9-186 BasicNet; pytorch/VITs.py
    + pytorch_vit_encoder.py VIT_encoder_CNN_decoder), as
    tests/test_importers.py replicates them. Two deliberate differences,
    which no weight sees: the ViT's GELU is the tanh form and its LayerNorm
    epsilon 1e-6 (flax's, which the port and JAX take; the reference's torch
    module takes erf and 1e-5), and its output is min-max normalised per
    sample (the reference normalises over the batch), so the check holds
    the import and the kernels and not that modelling difference."""
    nn = torch.nn

    class Encoder(nn.Module):
        def __init__(self, cin, f):
            super().__init__()
            widths = [(cin, f), (f, f), (f, f), (f, 2 * f), (2 * f, 2 * f), (2 * f, 2 * f),
                      (2 * f, 4 * f), (4 * f, 4 * f), (4 * f, 4 * f)]
            for i, (a, b) in enumerate(widths, start=1):
                setattr(self, f"conv{i}", nn.Conv2d(a, b, 3, padding=2, dilation=2))
            self.act = nn.LeakyReLU(0.1)

        def forward(self, x):
            a = self.act
            for s in range(3):
                c1, c2, c3 = (getattr(self, f"conv{3 * s + i}") for i in (1, 2, 3))
                x1 = a(c1(x))
                x2 = a(c2(x1)) + x1
                x = a(c3(x2)) + x2
                if s < 2:
                    x = a(nn.functional.max_pool2d(x, 2, 2))
            return x

    class Decoder(nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            h = cin // 2
            self.conv2dTranspose1 = nn.ConvTranspose2d(cin, h, 3, 2, 1, output_padding=1)
            self.conv2dTranspose2 = nn.ConvTranspose2d(h, h, 3, 1, 1)
            self.conv2dTranspose3 = nn.ConvTranspose2d(h, h, 3, 1, 1)
            self.conv2dTranspose4 = nn.ConvTranspose2d(h, cout, 3, 2, 1, output_padding=1)
            self.act = nn.LeakyReLU(0.1)

        def forward(self, x):
            a = self.act
            x1 = a(self.conv2dTranspose1(x))
            x2 = a(self.conv2dTranspose2(x1)) + x1
            x3 = a(self.conv2dTranspose3(x2)) + x2
            return a(self.conv2dTranspose4(x3))

    class RefBasicNet(nn.Module):
        def __init__(self, cin, cout, f):
            super().__init__()
            self.encoder = Encoder(cin, f)
            self.decoder = Decoder(4 * f, cout)

        def forward(self, x):
            return self.decoder(self.encoder(x))

    class Attention(nn.Module):
        def __init__(self, dim, heads, dim_head):
            super().__init__()
            self.heads, self.scale = heads, dim_head ** -0.5
            self.norm = nn.LayerNorm(dim, eps=1e-6)
            self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False)
            self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim))

        def forward(self, x):
            b, n, _ = x.shape
            q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                       for t in self.to_qkv(self.norm(x)).chunk(3, dim=-1))
            attn = torch.softmax(q @ k.transpose(-1, -2) * self.scale, dim=-1)
            return self.to_out((attn @ v).transpose(1, 2).reshape(b, n, -1))

    class FeedForward(nn.Module):
        def __init__(self, dim, hidden):
            super().__init__()
            self.net = nn.Sequential(nn.LayerNorm(dim, eps=1e-6), nn.Linear(dim, hidden),
                                     nn.GELU(approximate="tanh"), nn.Dropout(0.0),
                                     nn.Linear(hidden, dim))

        def forward(self, x):
            return self.net(x)

    class Transformer(nn.Module):
        def __init__(self, dim, depth, heads, dim_head, mlp):
            super().__init__()
            self.norm = nn.LayerNorm(dim, eps=1e-6)
            self.layers = nn.ModuleList(
                nn.ModuleList([Attention(dim, heads, dim_head), FeedForward(dim, mlp)])
                for _ in range(depth))

        def forward(self, x):
            for attn, ff in self.layers:
                x = attn(x) + x
                x = ff(x) + x
            return self.norm(x)

    class CustomViT(nn.Module):
        def __init__(self, img, p, dim, depth, heads, dim_head, mlp, cin):
            super().__init__()
            self.p, self.patch_dim = p, cin * p * p
            self.patch_to_embedding = nn.Linear(self.patch_dim, dim)
            self.norm = nn.LayerNorm(dim, eps=1e-6)
            self.pos_embedding = nn.Parameter(torch.randn(1, (img // p) ** 2, dim))
            self.cls_token = nn.Parameter(torch.randn(1, 1, dim))  # unused, as there
            self.transformer = Transformer(dim, depth, heads, dim_head, mlp)

        def forward(self, img):
            b, c = img.shape[:2]
            p = self.p
            patches = img.unfold(2, p, p).unfold(3, p, p).contiguous().view(b, c, -1, p, p)
            patches = patches.permute(0, 2, 1, 3, 4).reshape(b, -1, self.patch_dim)
            return self.transformer(self.norm(self.patch_to_embedding(patches))
                                    + self.pos_embedding)

    class ViTDecoder(nn.Module):
        def __init__(self, dim, cout, grid):
            super().__init__()
            self.dim, self.grid = dim, grid
            for i, o in enumerate((dim, dim, dim, cout), start=1):
                setattr(self, f"deconv{i}", nn.ConvTranspose2d(dim, o, 3, 2, 1,
                                                               output_padding=1))
            self.act = nn.LeakyReLU(0.1)

        def forward(self, x):
            # pytorch/VITs.py:40: the tokens reshaped as they lie in memory
            x = x.reshape(-1, self.dim, self.grid, self.grid)
            for i in range(1, 5):
                x = self.act(getattr(self, f"deconv{i}")(x))
            lo = x.amin(dim=(1, 2, 3), keepdim=True)
            hi = x.amax(dim=(1, 2, 3), keepdim=True)
            return (x - lo) / (hi - lo)

    class RefViTNet(nn.Module):
        def __init__(self, img, p, dim, depth, heads, dim_head, mlp, cin, cout):
            super().__init__()
            self.vit_encoder = CustomViT(img, p, dim, depth, heads, dim_head, mlp, cin)
            self.cnn_decoder = ViTDecoder(dim, cout, img // p)

        def forward(self, x):
            return self.cnn_decoder(self.vit_encoder(x))

    return RefBasicNet, RefViTNet


def reference_maps(torch, net, frames: np.ndarray, batch: int = CHUNK) -> np.ndarray:
    """The reference module's float32 forward (TF32 off) of NHWC frames, as
    NHWC maps, batch by batch on the card."""
    outs = []
    with torch.no_grad():
        for i in range(0, len(frames), batch):
            x = torch.from_numpy(frames[i : i + batch]).cuda().permute(0, 3, 1, 2)
            outs.append(net(x).permute(0, 2, 3, 1).cpu().numpy())
    return np.concatenate(outs)


def keras_save(path: str, layers: list) -> list:
    """Write ``layers`` -- [(layer name, [(weight name, array), ...]), ...]
    in the model's order -- as keras' ``model.save`` lays out an .h5 file,
    through the port's own HDF5 writer (data/h5.py): the root's
    ``backend``, ``keras_version`` and ``model_config`` strings,
    ``model_weights`` with its ``layer_names``, a group a layer with its
    ``weight_names`` ([] for a weightless layer) and each weight at
    ``model_weights/<layer>/<weight name>`` (tests/test_importers.py's
    ``_write_keras_h5`` and ``_write_keras_vit_h5`` compose it so). The
    (weight name, array) list in the model's order: what
    importers._keras_weight_list must read back."""
    from pose_estimation_amitai_torch.data import h5

    config = json.dumps({"class_name": "Functional", "config": {
        "name": "model", "layers": [{"name": name} for name, _ in layers]}})
    strings = {"backend": "tensorflow", "keras_version": "2.4.0"}
    attrs = {"": {**strings, "model_config": config},
             "model_weights": {"layer_names": [n.encode() for n, _ in layers], **strings}}
    arrays = {}
    for name, ws in layers:
        attrs[f"model_weights/{name}"] = {"weight_names": [w.encode() for w, _ in ws]}
        arrays.update((f"model_weights/{name}/{w}", a) for w, a in ws)
    h5.write_datasets(path, arrays, attrs)
    return [w for _, ws in layers for w in ws]


def keras_basicnet_layers(rng, filters: int, cin: int, cout: int, nb: int) -> list:
    """The reference's keras basic_nn (tensorflow/Network.py:127-145,
    416-474) as keras saves it, seeded: an input layer, then the
    Encoder2DAtrous and Decoder2D sub-models, each one group of
    ``conv2d_<i>`` kernels (kh, kw, I, O; a Conv2DTranspose's (kh, kw, O,
    I)) and biases -- 3 convs a block and 3 bottleneck convs, then a
    deconv and 2 convs a block up and the head deconv."""

    def conv(i, o, transposed=False):
        k = rng.normal(0, (9 * i) ** -0.5, (3, 3, o, i) if transposed else (3, 3, i, o))
        return k.astype(np.float32), rng.normal(0, 0.05, o).astype(np.float32)

    enc, c = [], cin
    for b in range(nb + 1):  # the last triple is the bottleneck
        f = filters * 2 ** b
        enc += [conv(c, f), conv(f, f), conv(f, f)]
        c = f
    dec = []
    for b in range(nb - 1, 0, -1):
        f = filters * 2 ** b
        dec += [conv(c, f, transposed=True), conv(f, f), conv(f, f)]
        c = f
    dec.append(conv(c, cout, transposed=True))

    def group(name, pairs):
        return name, [(f"{name}/conv2d{f'_{i}' if i else ''}/{leaf}:0", a)
                      for i, pair in enumerate(pairs) for leaf, a in zip(("kernel", "bias"), pair)]

    return [("x_in", []), group("Encoder2DAtrous", enc), group("Decoder2D", dec)]


def keras_vit_layers(rng, cfg, cin: int, cout: int, image: int = 192) -> list:
    """The reference's keras ViT (tensorflow/vitPose.py:100-130) as keras
    saves it, seeded, at ``cfg``'s widths for ``image``-pixel frames: patch
    extraction, the Dense patch
    embedding, the position Embedding, a block a layer of
    MultiHeadAttention (biased query, key, value, attention_output), a
    LayerNorm, two Dense and a LayerNorm, then 4 channel-halving
    Conv2DTranspose."""
    p, dim, heads = cfg.patch_size, cfg.projection_dim, cfg.num_heads
    dh = dim if cfg.dim_head else 64
    mlp = dim * cfg.fully_connected_expand

    def w(*shape, scale=0.05):
        return rng.normal(0, scale, shape).astype(np.float32)

    def named(layer, *leaves):
        return layer, [(f"{layer}/{leaf}:0", a) for leaf, a in leaves]

    def norm(n):
        name = f"layer_normalization_{n}" if n else "layer_normalization"
        return named(name, ("gamma", 1 + w(dim)), ("beta", w(dim)))

    layers = [("patch_extraction_layer", []),
              named("dense", ("kernel", w(p * p * cin, dim)), ("bias", w(dim))),
              named("embedding", ("embeddings", w((image // p) ** 2, dim)))]
    for i in range(cfg.transformer_layers):
        qkv = [(f"{part}/{leaf}", w(dim, heads, dh) if leaf == "kernel" else w(heads, dh))
               for part in ("query", "key", "value") for leaf in ("kernel", "bias")]
        layers += [
            named(f"multi_head_attention_{i}" if i else "multi_head_attention", *qkv,
                  ("attention_output/kernel", w(heads, dh, dim)),
                  ("attention_output/bias", w(dim))),
            norm(2 * i),
            named(f"dense_{2 * i + 1}", ("kernel", w(dim, mlp)), ("bias", w(mlp))),
            named(f"dense_{2 * i + 2}", ("kernel", w(mlp, dim)), ("bias", w(dim))),
            norm(2 * i + 1),
        ]
    c = dim
    for i, o in enumerate((dim // 2, dim // 4, dim // 8, cout)):
        layers.append(named(f"conv2d_transpose_{i}" if i else "conv2d_transpose",
                            ("kernel", w(3, 3, o, c, scale=(9 * c) ** -0.5)), ("bias", w(o))))
        c = o
    return layers


def flat_tree(tree: dict, prefix: str = "") -> list:
    """A nested dict's (path, leaf) pairs in path order."""
    return sorted((pair for k, v in tree.items() for pair in (
        flat_tree(v, f"{prefix}{k}/") if isinstance(v, dict) else [(f"{prefix}{k}", v)])),
        key=lambda pair: pair[0])


def same_weights(got: list, want: list) -> bool:
    """Names, dtypes, shapes and bits of two (name, array) lists equal."""
    return [n for n, _ in got] == [n for n, _ in want] and all(
        a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        for (_, a), (_, b) in zip(got, want))


def import_jax_run_directory(torch, params, frames, out: str) -> dict:
    """(a) of the import phase: the flagship's seeded tree written as the
    JAX package's save_params writes best_model.msgpack (the port's
    pack_flax_msgpack), read back bit-equal by load_flax_checkpoint, and
    the run directory served on "fused" through Predictor.from_checkpoint,
    its maps and peaks bit-equal to a Predictor built from the tree in
    memory; B1 and B2's counters around the 612 frames."""
    import os

    from pose_estimation_amitai_torch import Config, weights
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd

    t0 = time.perf_counter()
    run = os.path.join(out, "jax_run")
    os.makedirs(run)
    blob = weights.pack_flax_msgpack(params)
    with open(os.path.join(run, "best_model.msgpack"), "wb") as f:
        f.write(blob)
    t1 = time.perf_counter()
    tree, stats = weights.load_flax_checkpoint(run)
    t_read = time.perf_counter() - t1
    check(stats == {} and same_weights(flat_tree(tree), flat_tree(params)),
          "the JAX run directory's tree is not the tree written")
    kw = dict(use_fused=True, device="cuda", chunk_size=CHUNK, return_heatmaps=True)
    pred = Predictor.from_checkpoint(Config(), run, (192, 192, 4), 18, **kw)
    check(pred.serving_path == "fused", f"the JAX run directory served {pred.serving_path}")
    pred(frames[:1])  # warm-up
    # ---- the 612 frames: counters zeroed just before, read just after ----
    zero_conv_counters(hc, hd)
    answers, start = [], 0
    for n in REQUESTS:
        answers.append(pred(frames[start:start + n]))
        start += n
    launches = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                "fused_decoder": hd.fused_decoder.launches}
    # ----------------------------------------------------------------------
    chunks = sum(-(-n // CHUNK) for n in REQUESTS)
    check(launches == {"fused_encoder_stage": 3 * chunks, "fused_decoder": chunks},
          f"the JAX run directory's requests took {launches}")
    maps = np.concatenate([m for m, _ in answers])
    pts = np.concatenate([p for _, p in answers])
    del answers
    want_maps, want_pts = Predictor(Config(), params, (192, 192, 4), 18, **kw)(frames)
    check(np.array_equal(maps, want_maps) and np.array_equal(pts, want_pts),
          "the JAX run directory's maps differ from the in-memory tree's")
    return {"checkpoint_bytes": len(blob), "read_seconds": t_read, "route": "fused",
            "frames": len(frames), "launches": launches, "maps_bit_equal": True,
            "seconds": time.perf_counter() - t0}


def import_keras_saves(torch, frames, out: str) -> dict:
    """(b) of the import phase: keras saves written by the port's HDF5
    writer and read by its reader. The tf-flavour basic_nn at Config()
    (filters 64, 4 -> 18) served on "module" in float32 (its maps within
    1e-4 of max of the same import's on the CPU, on 2 frames); the ViT at
    Config()'s widths through ``cli import`` to a snapshot, then served on
    "fused" from the .h5 (import_reference=True; S1's counter around the
    bf16 run) and on "module" from the snapshot, the routes within the
    import tolerances of each other. For each, _keras_weight_list reads
    back exactly the names and bits written."""
    import contextlib
    import io
    import os

    from pose_estimation_amitai_torch import Config, cli, importers
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_attention as ha

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cfg = Config(compute_dtype="float32")
    path = os.path.join(out, "basic_nn.h5")
    layers = keras_basicnet_layers(rng, cfg.num_base_filters, 4, 18, cfg.num_blocks)
    t1 = time.perf_counter()
    written = keras_save(path, layers)
    t2 = time.perf_counter()
    check(importers.is_reference_checkpoint(path) and same_weights(
        importers._keras_weight_list(path), written), "the keras basic_nn did not read back")
    io_s = {"write_seconds": t2 - t1, "read_seconds": time.perf_counter() - t2}
    arch = importers.import_reference_checkpoint(path).arch_kwargs
    check(arch == {"out_channels": 18, "in_channels": 4, "filters": cfg.num_base_filters,
                   "kernel_size": 3, "dilation": 2, "num_blocks": cfg.num_blocks},
          f"the keras basic_nn imported as {arch}")
    pred = Predictor.from_checkpoint(cfg, path, (192, 192, 4), 18, device="cuda",
                                     chunk_size=CHUNK, return_heatmaps=True)
    check(pred.serving_path == "module", f"the keras basic_nn served {pred.serving_path}")
    maps, pts = pred(frames)
    cpu, _ = Predictor.from_checkpoint(cfg, path, (192, 192, 4), 18, device="cpu",
                                       chunk_size=KERAS_CPU_FRAMES,
                                       return_heatmaps=True)(frames[:KERAS_CPU_FRAMES])
    top = float(np.abs(cpu).max())
    basic_err = float(np.abs(maps[:KERAS_CPU_FRAMES] - cpu).max())
    check(basic_err <= IMPORT_F32_RTOL * top and bool(np.isfinite(maps).all())
          and pts.shape == (len(frames), 3, 18),
          f"the keras basic_nn's maps, card vs CPU: {basic_err} > {IMPORT_F32_RTOL} x {top}")
    basic = {"arch_kwargs": arch, "route": "module", "max_abs_err_vs_cpu": basic_err,
             "max_abs_maps": top, "weights": len(written),
             "file_bytes": os.path.getsize(path), **io_s}
    del maps, pred

    vcfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT)
    vpath, snap = os.path.join(out, "vit_model.h5"), os.path.join(out, "vit_snapshot.pt")
    layers = keras_vit_layers(rng, vcfg, 4, 18)
    t1 = time.perf_counter()
    written = keras_save(vpath, layers)
    t2 = time.perf_counter()
    check(same_weights(importers._keras_weight_list(vpath), written),
          "the keras ViT did not read back")
    t3 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        check(cli.main(["import", vpath, snap]) == 0, "cli import of the keras ViT failed")
    io_s = {"write_seconds": t2 - t1, "read_seconds": t3 - t2,
            "cli_import_seconds": time.perf_counter() - t3}
    imported = importers.import_reference_checkpoint(vpath)
    snapped = importers.load_imported_snapshot(snap)
    check(snapped.arch_kwargs == imported.arch_kwargs and same_weights(
        flat_tree(snapped.params), flat_tree(imported.params)),
        "the keras ViT's snapshot differs from its import")
    routes, launches = {}, 0
    for dt, rtol in (("float32", IMPORT_F32_RTOL), ("bfloat16", IMPORT_BF16_RTOL)):
        maps = {}
        for route, src, flags in (("fused", vpath, {"import_reference": True}),
                                  ("module", snap, {})):
            pred = Predictor.from_checkpoint(vcfg.replace(compute_dtype=dt), src,
                                             (192, 192, 4), 18, device="cuda",
                                             chunk_size=CHUNK, return_heatmaps=True,
                                             use_fused=route == "fused", **flags)
            check(pred.serving_path == route, f"the keras ViT served {pred.serving_path}")
            if route == "fused" and dt == "bfloat16":
                pred(frames[:1])  # warm-up
                # ---- counters zeroed just before, read just after ----
                ha.fused_attention.launches = 0
                maps[route] = pred(frames)[0]
                launches = ha.fused_attention.launches
                # ------------------------------------------------------
            else:
                maps[route] = pred(frames)[0]
        top = float(np.abs(maps["module"]).max())
        err = float(np.abs(maps["fused"] - maps["module"]).max())
        check(err <= rtol * top and bool(np.isfinite(maps["fused"]).all()),
              f"the keras ViT {dt}: fused vs module {err} > {rtol} x {top}")
        routes[dt] = {"max_abs_err": err, "max_abs_maps": top}
    check(launches == vcfg.transformer_layers * -(-len(frames) // CHUNK),
          f"the keras ViT's fused run took {launches} attention launches")
    vit = {"arch_kwargs": imported.arch_kwargs, "cli_import": json.loads(said.getvalue()),
           "fused_vs_module": routes, "launches": {"fused_attention": launches},
           "weights": len(written), "file_bytes": os.path.getsize(vpath), **io_s}
    return {"BasicNet": basic, "ViT": vit, "seconds": time.perf_counter() - t0}


def phase_import(torch, params, frames, device_name: str, smi: str) -> dict:
    """Reference-layout checkpoints at full width, imported and served
    through Predictor.from_checkpoint(import_reference=True) on the module
    and fused routes, held to the reference module's own forward; then a
    JAX run directory and keras saves, read by the port's own msgpack and
    HDF5 readers."""
    import os
    import tempfile

    from pose_estimation_amitai_torch import Config, importers
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.ops import hopper_attention as ha
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd

    t_phase = time.perf_counter()
    RefBasicNet, RefViTNet = reference_modules(torch)
    vcfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT)
    dim, dim_head = vcfg.projection_dim, vcfg.projection_dim if vcfg.dim_head else 64
    torch.manual_seed(SEED)
    nets = {
        "BasicNet": RefBasicNet(4, 18, Config().num_base_filters),
        "ViT": RefViTNet(192, vcfg.patch_size, dim, vcfg.transformer_layers, vcfg.num_heads,
                         dim_head, dim * vcfg.fully_connected_expand, 4, 18),
    }
    models, launches = {}, {}
    with tempfile.TemporaryDirectory() as out:
        for name, net in nets.items():
            net = net.cuda().eval()
            sample = torch.from_numpy(frames[:2]).cuda().permute(0, 3, 1, 2)
            dict_path = os.path.join(out, f"{name}_checkpoint.pth")
            torch.save({"epoch": 1, "model_state_dict": net.state_dict()}, dict_path)
            script_path = os.path.join(out, f"{name}_best_model.pth")
            with torch.no_grad():
                torch.jit.trace(net, sample).save(script_path)
            kinds = [importers.archive_kind(p) for p in (dict_path, script_path)]
            check(kinds == ["torch_save", "torchscript"], f"{name} archives {kinds}")
            a = importers.import_reference_checkpoint(dict_path, dim_head=dim_head)
            b = importers.import_reference_checkpoint(script_path, dim_head=dim_head)
            check(a.arch_kwargs == b.arch_kwargs and all(
                np.array_equal(x, y) for x, y in zip(_leaves(a.params), _leaves(b.params))),
                f"{name}: the dict and TorchScript imports differ")
            want = reference_maps(torch, net, frames)
            top = float(np.abs(want).max())
            routes = {}
            for route, path in (("module", dict_path), ("fused", script_path)):
                for dt in ("float32", "bfloat16"):
                    pred = Predictor.from_checkpoint(
                        Config(compute_dtype=dt), path, (192, 192, 4), 18, device="cuda",
                        chunk_size=CHUNK, use_fused=route == "fused", return_heatmaps=True,
                        import_reference=True, dim_head=dim_head)
                    check(pred.serving_path == route, f"{name} served {pred.serving_path}")
                    if route == "fused" and dt == "bfloat16":
                        pred(frames[:1])  # warm-up
                        # ---- counters zeroed just before, read just after ----
                        zero_conv_counters(hc, hd)
                        ha.fused_attention.launches = 0
                        maps, pts = pred(frames)
                        launches[name] = {
                            "fused_encoder_stage": hc.fused_encoder_stage.launches,
                            "fused_decoder": hd.fused_decoder.launches,
                            "fused_attention": ha.fused_attention.launches}
                        # -------------------------------------------------------
                    else:
                        maps, pts = pred(frames)
                    err = float(np.abs(maps - want).max())
                    tol = (IMPORT_F32_RTOL if dt == "float32" else IMPORT_BF16_RTOL) * top
                    check(err <= tol and bool(np.isfinite(pts).all()),
                          f"{name} {route} {dt}: maps {err} off the reference > {tol}")
                    routes[f"{route}_{dt}"] = err
            models[name] = {"arch_kwargs": a.arch_kwargs, "max_abs_maps": top,
                            "max_abs_err": routes}
            del net
        t_torch = time.perf_counter() - t_phase
        jax_run = import_jax_run_directory(torch, params, frames, out)
        keras = import_keras_saves(torch, frames, out)
    chunks = -(-len(frames) // CHUNK)
    check(launches["BasicNet"] == {"fused_encoder_stage": 3 * chunks,
                                   "fused_decoder": chunks, "fused_attention": 0}
          and launches["ViT"] == {"fused_encoder_stage": 0, "fused_decoder": 0,
                                  "fused_attention": vcfg.transformer_layers * chunks},
          f"the imported models' fused launches {launches}")
    result = {"phase": "import", "device": device_name, "nvidia_smi": smi,
              "model": "reference-layout torch BasicNet (filters 64, 4 -> 18) and "
                       "VIT_encoder_CNN_decoder (patch 16, dim 256, depth 8, heads 8, "
                       "dim_head 256), seeded, as checkpoint.pth dicts and traced "
                       "TorchScript best_model.pth",
              "frames": len(frames), "models": models, "launches": launches,
              "rtol": {"float32": IMPORT_F32_RTOL, "bfloat16": IMPORT_BF16_RTOL},
              "torch_seconds": t_torch, "jax_run_directory": jax_run, "keras": keras,
              "seconds": time.perf_counter() - t_phase}
    emit(result)
    return result


def _leaves(tree):
    return [leaf for _, leaf in flat_tree(tree)]


def export_case(torch, name: str, pred, frames, gaps, tmp: str, timed: bool) -> dict:
    """Export ``pred``, load the artifact on the card and serve ``frames``:
    peaks against the Predictor's (x, y equal where ``gaps`` exceed
    EXPORT_GAP; values within EXPORT_F32_RTOL of max in float32, equal where
    they are), the kernels' launches around the loaded program and, with
    ``timed``, frames/s of both."""
    import os

    from pose_estimation_amitai_torch.deploy import export_predictor, load_exported
    from pose_estimation_amitai_torch.ops import custom_ops
    from pose_estimation_amitai_torch.ops import hopper_attention as ha
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.ops import hopper_qconv as hq

    path = os.path.join(tmp, f"{name}.ptexp")
    t0 = time.perf_counter()
    header = export_predictor(pred, path)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_exported(path, "cuda")
    t_load = time.perf_counter() - t0
    graph_ops = sorted({str(n.target).split(".")[1] for n in loaded.module.graph.nodes
                        if str(n.target).startswith(custom_ops.NAMESPACE + ".")})
    loaded(frames[:1])  # warm-up
    counters = (hc.fused_encoder_stage, hd.fused_decoder, hq.fused_quantized_stage,
                ha.fused_attention)
    # ---- the loaded program: counters zeroed just before, read just after ----
    for c in counters:
        c.launches = 0
    got = loaded(frames)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    # ---------------------------------------------------------------------------
    want = pred(frames)
    clear = gaps > EXPORT_GAP
    xy_equal = (got[:, :2] == want[:, :2]).all(axis=1)
    check(got.shape == want.shape and bool(xy_equal[clear].all()),
          f"export {name}: peaks differ where the gap is clear "
          f"({int((~xy_equal & clear).sum())} of {int(clear.sum())})")
    val_err = float(np.abs(got[:, 2] - want[:, 2])[xy_equal].max())
    top = float(np.abs(want[:, 2]).max())
    f32 = header.get("serving_path") in ("module", "fused") and pred.cfg.compute_dtype == "float32"
    check(val_err <= (EXPORT_F32_RTOL * top if f32 else 0.0),
          f"export {name}: peak values {val_err} off the Predictor's (max {top})")
    case = {"serving_path": header["serving_path"], "bytes": os.path.getsize(path),
            "export_seconds": t_export, "load_seconds": t_load, "graph_ops": graph_ops,
            "launches": launches, "clear_share": float(clear.mean()),
            "xy_equal_share": float(xy_equal.mean()), "val_max_abs_err": val_err}
    if timed:
        fps = {"program": [], "predictor": []}
        for _ in range(EXPORT_REPS):
            for key, fn in (("predictor", pred), ("program", loaded), ("program", loaded),
                            ("predictor", pred)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(frames)
                torch.cuda.synchronize()
                fps[key].append(len(frames) / (time.perf_counter() - t0))
        case["frames_per_s"] = {k: float(np.mean(v)) for k, v in fps.items()}
    return case


def phase_export(torch, params, frames, device_name: str, smi: str) -> dict:
    """The serving artifact: the flagship's module, fused and int8_fused
    routes and the ViT's fused route exported at full width, loaded on the
    card and served; the float32 programs held within EXPORT_F32_RTOL."""
    import tempfile

    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch.infer import Predictor

    t_phase = time.perf_counter()
    vcfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT)
    vparams = vit_params(vcfg, 4, 18, four=False)
    calib = frames[:CALIB_FRAMES]
    cases = {
        "module": (Config(), params, {}),
        "fused": (Config(), params, {"use_fused": True}),
        "int8_fused": (Config(), params, {"use_fused": True, "use_quantized": True,
                                          "calibration_frames": calib}),
        "vit_fused": (vcfg, vparams, {"use_fused": True}),
        "module_f32": (Config(compute_dtype="float32"), params, {}),
        "fused_f32": (Config(compute_dtype="float32"), params, {"use_fused": True}),
        "vit_fused_f32": (vcfg.replace(compute_dtype="float32"), vparams, {"use_fused": True}),
    }
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (cfg, p, kw) in cases.items():
            f32 = name.endswith("_f32")
            sub = frames[:CHUNK] if f32 else frames
            twin = Predictor(cfg, p, (192, 192, 4), 18, device="cuda", chunk_size=CHUNK,
                             return_heatmaps=True, **kw)
            maps, _ = twin(sub)
            gaps = top_two_gap(maps)
            del twin, maps
            pred = Predictor(cfg, p, (192, 192, 4), 18, device="cuda", chunk_size=CHUNK, **kw)
            results[name] = export_case(torch, name, pred, sub, gaps, tmp, timed=not f32)
            del pred
    chunks = -(-len(frames) // CHUNK)
    want = {"module": {}, "fused": {"fused_encoder_stage": 3 * chunks,
                                    "fused_decoder": chunks},
            "int8_fused": {"fused_quantized_stage": 3 * chunks},
            "vit_fused": {"fused_attention": vcfg.transformer_layers * chunks}}
    for name, w in want.items():
        got = {k: v for k, v in results[name]["launches"].items() if v}
        check(got == w, f"export {name}: the loaded program launched {got}, not {w}")
    launches = {}
    for name in ("fused", "int8_fused", "vit_fused"):
        launches.update({k: v for k, v in results[name]["launches"].items() if v})
    result = {"phase": "export", "device": device_name, "nvidia_smi": smi,
              "model": "flagship BasicNet (filters 64, 192x192x4 -> 18) and ViTPoseNet "
                       "(dim 256, depth 8), seeded, chunk 256; bf16, and float32 with "
                       "TF32 off for the *_f32 cases (one chunk)",
              "frames": len(frames), "cases": results, "launches": launches,
              "gap": EXPORT_GAP, "f32_rtol": EXPORT_F32_RTOL,
              "seconds": time.perf_counter() - t_phase}
    emit(result)
    return result


# the parallel phase: every strategy at degree 1 on a one-rank NCCL group,
# at full width; with 2 or more cards also a 2-rank NCCL world
PAR_WARMUP, PAR_STEPS = 3, 10  # the data-parallel and pipelined steps
PAR_CHECK_STEPS = 3  # steps held against the plain step, deterministic cuDNN
PAR_LOSS_RTOL = 1e-6  # sharded vs plain step's loss, relative
PAR_ZOO_STEPS = 2  # RESNET_18_POINTS_PER_WING: sharded vs plain steps
PAR_STATS_RTOL = 1e-6  # its running averages, of each tensor's largest
PAR_MICRO = 4  # the pipeline's microbatches at batch 8
PAR_PIPE_RTOL = 1e-4  # pipelined vs sequential, float32, of max
PAR_GAP = 2e-4  # ViT fused peaks equal module's wherever the top-two gap exceeds this
PAR_SEQ = (64, 576, 4, 256)  # ring attention: the 4-camera ViT's fused sequence
PAR_SEQ_BF16_ATOL = 3e-2  # bf16 ring vs reference (tests/test_sequence_parallel.py)
PAR_MOE = (256, 1024, 8, 64, 144)  # dim, hidden, experts, batch, tokens
PAR_RTOL = 1e-5  # ring attention and the MoE in float32, of max
PAR_REPS = 10  # timed calls of the ring and the MoE
PAR_RANKS = 2  # the multi-card world where the machine has the cards


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def steps_ms(torch, step, state, batches, warmup: int):
    """(state, losses, mean ms of the steps after ``warmup``, CUDA events):
    ``step(state, batch) -> (state, loss)`` over ``batches``."""
    losses = []
    for b in batches[:warmup]:
        state, loss = step(state, b)
        losses.append(loss)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for b in batches[warmup:]:
        state, loss = step(state, b)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    return state, torch.stack(losses).float().cpu().numpy(), \
        start.elapsed_time(end) / max(1, len(batches) - warmup)


def sharded_vs_plain(torch, model, cfg, ds, mesh, idx) -> dict:
    """The data-parallel step (degree 1) against the plain step on the same
    batches, deterministic cuDNN: every loss within PAR_LOSS_RTOL, the first
    step's parameters within what Adam's eps explains (the train phase's
    rule), the running averages within PAR_STATS_RTOL."""
    from pose_estimation_amitai_torch.parallel.sharded import make_sharded_train_step, shard_state
    from pose_estimation_amitai_torch.train import loop

    torch.backends.cudnn.deterministic = True
    try:
        state0 = loop.create_train_state(model, cfg, seed=SEED, device="cuda")
        plain, sharded = loop.make_train_step(model, cfg), make_sharded_train_step(model, cfg, mesh)
        p, s = state0, shard_state(mesh, state0)
        worst, firsts = 0.0, None
        for i, ix in enumerate(idx):
            p, lp = plain(p, ds.data, ix)
            s, ls = sharded(s, ds.microbatch_arrays(ix))
            worst = max(worst, abs(float(ls) - float(lp)) / abs(float(lp)))
            if i == 0:
                firsts = (p, s)
    finally:
        torch.backends.cudnn.deterministic = False
    check(worst <= PAR_LOSS_RTOL, f"sharded vs plain loss {worst} > {PAR_LOSS_RTOL}")
    (p1, s1), excess = firsts, 0.0
    for i, name in enumerate(p1.params):
        gp = p1.opt_state["state"][i]["exp_avg"] / 0.1  # Adam's first moment, (1 - b1) g
        gs = s1.opt_state["state"][i]["exp_avg"] / 0.1
        same = torch.sign(gp) == torch.sign(gs)
        explained = cfg.learning_rate * ADAM_EPS * (gp - gs).abs() / (
            (gp.abs() + ADAM_EPS) * (gs.abs() + ADAM_EPS))
        d = ((p1.params[name] - s1.params[name]).abs() - explained)[same]
        excess = max(excess, float(d.max()) if d.numel() else 0.0)
    check(excess <= TRAIN_PARAM_ATOL, f"sharded vs plain parameters {excess} beyond Adam's eps")
    stats_err = max([float((s.batch_stats[k] - v).abs().max() / v.abs().max())
                     for k, v in p.batch_stats.items()], default=0.0)
    check(stats_err <= PAR_STATS_RTOL, f"running averages off by {stats_err}")
    return {"steps": len(idx), "loss_max_rel_err": worst, "param_excess": excess,
            "stats_max_rel_err": stats_err, "batch_stats": len(p.batch_stats)}


def parallel_ranks_body(rank: int, world: int, port: int, out: str) -> None:
    """One rank of the multi-card world: the data-parallel step (float32,
    augmentation and dropout on) and the pipelined forward at pipe
    ``world``, saved for the parent to hold against its one-rank results."""
    import os
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=300),
                            device_id=torch.device("cuda", rank))
    try:
        torch.save(parallel_checks(torch, world), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def parallel_checks(torch, world: int) -> dict:
    """What the multi-card world repeats, run the same way at ``world``
    ranks and at one: one float32 data-parallel step of the flagship
    (augmentation, dropout 0.5) from the seed over the same global batch,
    and the pipelined ViT's float32 forward at pipe ``world``."""
    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch.data import build_dataset
    from pose_estimation_amitai_torch.models import build_model, vit_single_kwargs
    from pose_estimation_amitai_torch.parallel import pipeline
    from pose_estimation_amitai_torch.parallel.mesh import data_rows, make_mesh
    from pose_estimation_amitai_torch.parallel.sharded import make_sharded_train_step, shard_state
    from pose_estimation_amitai_torch.train import loop

    cfg = Config(compute_dtype="float32")
    arrays = train_arrays()
    ds, _ = build_dataset(cfg, arrays, device="cuda")
    k = TRAIN_POINTS // 2 + 2
    with torch.device("meta"):
        model = build_model(cfg, (192, 192, 4), k)
    mesh = make_mesh((world,), "cuda")
    idx = ds.step_indices(cfg.batch_size, cfg.accumulation_steps)
    state = shard_state(mesh, loop.create_train_state(model, cfg, seed=SEED, device="cuda"))
    new, loss = make_sharded_train_step(model, cfg, mesh)(
        state, ds.microbatch_arrays(idx[:, data_rows(mesh, idx.shape[1])]))
    out = {"loss": float(loss),
           "params": {n: v.cpu() for n, v in new.params.items()},
           "grads": {n: s["exp_avg"].cpu() / 0.1
                     for n, s in zip(new.params, new.opt_state["state"].values())}}
    vcfg = Config(model_type="MODEL_18_POINTS_PER_WING_VIT", compute_dtype="float32")
    pmesh = pipeline.make_pipeline_mesh(1, world, "cuda")
    pipe = pipeline.PipelinedViT(pmesh, image_hw=192, in_channels=4,
                                 num_microbatches=PAR_MICRO,
                                 **vit_single_kwargs(vcfg, k))
    params = pipe.init(torch.Generator(device="cuda").manual_seed(SEED))
    x = ds.data["box"][: cfg.batch_size]
    with torch.no_grad():
        out["pipe"] = pipe.apply(pipe.shard_params(params), x).cpu()
        out["sequential"] = pipe.apply_sequential(params, x).cpu()
    return out


def parallel_world(torch, world: int, one: dict) -> dict:
    """A ``world``-rank NCCL world (one process a card) repeating
    :func:`parallel_checks`, held against the one-rank results ``one``:
    the loss within TRAIN_LOSS_RTOL, gradients within TRAIN_GRAD_RTOL of
    their largest, parameters by the train phase's Adam rule; the pipelined
    forward within PAR_PIPE_RTOL of the sequential one's max."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out:
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=parallel_ranks_body, args=(r, world, port, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(30)
        check(not alive and all(p.exitcode == 0 for p in procs),
              f"the {world}-rank world failed: exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(f"{out}/rank{r}.pt", weights_only=False) for r in range(world)]
    worst = {"loss": 0.0, "grad": 0.0, "param_excess": 0.0, "pipe": 0.0}
    for res in ranks:
        worst["loss"] = max(worst["loss"], abs(res["loss"] - one["loss"]) / abs(one["loss"]))
        for n, w in one["params"].items():
            g, wg = res["grads"][n], one["grads"][n]
            worst["grad"] = max(worst["grad"], float((g - wg).abs().max() / wg.abs().max()))
            same = torch.sign(g) == torch.sign(wg)
            explained = 1e-3 * ADAM_EPS * (g - wg).abs() / ((g.abs() + ADAM_EPS) * (wg.abs() + ADAM_EPS))
            d = ((res["params"][n] - w).abs() - explained)[same]
            worst["param_excess"] = max(worst["param_excess"], float(d.max()) if d.numel() else 0.0)
        ref = one["sequential"]
        worst["pipe"] = max(worst["pipe"], float((res["pipe"] - ref).abs().max() / ref.abs().max()))
    check(worst["loss"] <= TRAIN_LOSS_RTOL and worst["grad"] <= TRAIN_GRAD_RTOL
          and worst["param_excess"] <= TRAIN_PARAM_ATOL and worst["pipe"] <= PAR_PIPE_RTOL,
          f"the {world}-rank world against one rank: {worst}")
    return worst


def phase_parallel(torch, params, frames, device_name: str, smi: str) -> dict:
    """The parallel strategies (parallel/) on a one-rank NCCL group on card 0
    at full width: data parallelism (the flagship and the cross-replica
    BatchNorm of RESNET_18_POINTS_PER_WING against the plain step, the
    flagship's steps timed), the pipelined ViT (forward against the
    sequential one, steps timed, its weights served on "fused" through the
    attention kernel), ring attention and the MoE against their one-process
    functions, and Predictor(mesh=) on the flagship's "fused" route through
    the encoder-stage and decoder kernels; with two or more cards, a 2-rank
    world repeats the data-parallel and pipeline checks."""
    import torch.distributed as dist

    from pose_estimation_amitai_torch import Config
    from pose_estimation_amitai_torch import constants as C
    from pose_estimation_amitai_torch import weights
    from pose_estimation_amitai_torch.data import build_dataset
    from pose_estimation_amitai_torch.infer import Predictor
    from pose_estimation_amitai_torch.models import build_model, vit_single_kwargs
    from pose_estimation_amitai_torch.ops import hopper_attention as ha
    from pose_estimation_amitai_torch.ops import hopper_conv as hc
    from pose_estimation_amitai_torch.ops import hopper_deconv as hd
    from pose_estimation_amitai_torch.parallel import expert, pipeline, sequence
    from pose_estimation_amitai_torch.parallel.mesh import make_mesh
    from pose_estimation_amitai_torch.parallel.sharded import make_sharded_train_step, shard_state
    from pose_estimation_amitai_torch.train import loop

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        mesh = make_mesh((1,), "cuda")
        result = {"phase": "parallel", "device": device_name, "nvidia_smi": smi,
                  "backend": "nccl", "ranks": 1}

        # (a) data parallelism: the flagship at Config(), then RESNET's BatchNorm
        cfg = Config()
        arrays = train_arrays()
        ds, _ = build_dataset(cfg, arrays, device="cuda")
        k = TRAIN_POINTS // 2 + 2
        with torch.device("meta"):
            model = build_model(cfg, (192, 192, 4), k)
        idx = [ds.step_indices(cfg.batch_size, cfg.accumulation_steps)
               for _ in range(PAR_WARMUP + PAR_STEPS)]
        result["dp_check"] = sharded_vs_plain(torch, model, cfg, ds, mesh, idx[:PAR_CHECK_STEPS])
        state0 = loop.create_train_state(model, cfg, seed=SEED, device="cuda")
        sharded = make_sharded_train_step(model, cfg, mesh)
        plain = loop.make_train_step(model, cfg)
        batches = [ds.microbatch_arrays(ix) for ix in idx]
        timed = {}
        for name in ("plain", "sharded", "sharded", "plain"):  # in turns
            if name == "plain":
                _, losses, ms = steps_ms(torch, lambda s, ix: plain(s, ds.data, ix), state0,
                                         idx, PAR_WARMUP)
            else:
                _, losses, ms = steps_ms(torch, sharded, shard_state(mesh, state0), batches,
                                         PAR_WARMUP)
            check(bool(np.isfinite(losses).all()), f"{name}: non-finite losses")
            timed.setdefault(name, []).append(ms)
        result["dp_step_ms"] = float(np.mean(timed["sharded"]))
        result["plain_step_ms"] = float(np.mean(timed["plain"]))
        zcfg = Config(model_type=C.RESNET_18_POINTS_PER_WING)
        with torch.device("meta"):
            zmodel = build_model(zcfg, (192, 192, 4), k)
        result["resnet_check"] = sharded_vs_plain(torch, zmodel, zcfg, ds, mesh,
                                                  idx[:PAR_ZOO_STEPS])
        check(result["resnet_check"]["batch_stats"] > 0, "RESNET has no running averages")
        del batches

        # (b) the pipelined ViT at full width, pipe 1
        vcfg = Config(model_type=C.MODEL_18_POINTS_PER_WING_VIT)
        pmesh = pipeline.make_pipeline_mesh(1, 1, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        pipe32 = pipeline.PipelinedViT(pmesh, image_hw=192, in_channels=4,
                                       num_microbatches=PAR_MICRO,
                                       **vit_single_kwargs(vcfg.replace(compute_dtype="float32"), k))
        vparams = pipe32.init(gen)
        x = ds.data["box"][: cfg.batch_size]
        with torch.no_grad():
            a = pipe32.apply(vparams, x)
            b = pipe32.apply_sequential(vparams, x)
        pipe_err = float((a - b).abs().max() / b.abs().max())
        check(pipe_err <= PAR_PIPE_RTOL, f"pipelined vs sequential {pipe_err} > {PAR_PIPE_RTOL}")
        pipe = pipeline.PipelinedViT(pmesh, image_hw=192, in_channels=4,
                                     num_microbatches=PAR_MICRO, **vit_single_kwargs(vcfg, k))
        init_opt, pstep = pipeline.make_pipelined_train_step(pipe, vcfg.learning_rate)
        pbatches = [ds.gather(ix[0]) for ix in idx]
        trained, plosses, pipe_ms = steps_ms(
            torch, lambda st, bt: (lambda r: ((r[0], r[1]), r[2]))(pstep(*st, bt)),
            (vparams, init_opt(vparams)), pbatches, PAR_WARMUP)
        check(bool(np.isfinite(plosses).all()), f"pipelined losses {plosses}")
        # its weights as ViTPoseNet's (pipeline_params_to_vit), served on
        # "fused": the 612 frames in bf16 with S1's counter around them, and
        # held against "module" in float32 (maps within VIT_F32_ATOL, peaks
        # equal wherever the top-two gap exceeds 2 * VIT_F32_ATOL = PAR_GAP)
        vit_sd = pipeline.pipeline_params_to_vit(trained[0])
        with torch.device("meta"):
            vit = build_model(vcfg, (192, 192, 4), k)
        vtree = weights.state_dict_to_flax(vit_sd, vit)

        def vpred(c, **kw):
            return Predictor(c, vtree, (192, 192, 4), k, device="cuda", chunk_size=CHUNK, **kw)

        fused = vpred(vcfg, use_fused=True)
        fused(frames[:1])
        ha.fused_attention.launches = 0  # ---- the served pipeline weights ----
        answers, movie, t_vit, _ = serve(fused, frames)
        s1 = ha.fused_attention.launches  # -------------------------------------
        check_peaks(answers, movie, len(frames), k)
        c32 = vcfg.replace(compute_dtype="float32")
        check(2 * VIT_F32_ATOL == PAR_GAP, "the gap is twice the float32 tolerance")
        routes = compare_routes(torch, vpred(c32, use_fused=True, return_heatmaps=True)(frames),
                                vpred(c32, return_heatmaps=True)(frames), VIT_F32_ATOL,
                                "float32")
        result["pipeline"] = {"pipe": 1, "microbatches": PAR_MICRO, "f32_max_rel_err": pipe_err,
                              "step_ms": pipe_ms, "losses": [float(plosses[0]), float(plosses[-1])],
                              "served_frames": len(frames), "fused_frames_per_s": len(frames) / t_vit,
                              "s1_launches": s1, "fused_vs_module_f32": routes}

        # (c) ring attention at seq 1 and the MoE at expert 1
        b, n, h, d = PAR_SEQ
        q, kk, v = (torch.randn(b, n, h, d, generator=gen, device="cuda") for _ in range(3))
        smesh = sequence.make_seq_mesh(1, 1, "cuda")
        ring = {}
        for dt in (torch.float32, torch.bfloat16):
            qq, k2, vv = (t.to(dt) for t in (q, kk, v))
            got = sequence.ring_attention(qq, k2, vv, smesh)
            want = sequence.reference_attention(qq, k2, vv)
            err = float((got.float() - want.float()).abs().max())
            tol = PAR_RTOL * float(want.float().abs().max()) if dt == torch.float32 else PAR_SEQ_BF16_ATOL
            check(got.dtype == dt and err <= tol, f"ring attention {dt}: {err} > {tol}")
            ring[str(dt).split(".")[1]] = {
                "max_abs_err": err,
                "ms": time_ms(torch, lambda: sequence.ring_attention(qq, k2, vv, smesh), PAR_REPS),
                "reference_ms": time_ms(torch, lambda: sequence.reference_attention(qq, k2, vv),
                                        PAR_REPS)}
            del got, want
        del q, kk, v
        dim, hidden, e, mb, tok = PAR_MOE
        moe = expert.MoEFeedForward(expert.make_expert_mesh(1, 1, "cuda"), dim=dim,
                                    hidden_dim=hidden, num_experts=e)
        mp = moe.init(gen)
        local = moe.shard_params(mp)
        t = torch.randn(mb, tok, dim, generator=gen, device="cuda")
        got, want = moe.apply(local, t), moe.apply_dense(mp, t)
        moe_err = float((got - want).abs().max())
        check(moe_err <= PAR_RTOL * float(want.abs().max()), f"MoE {moe_err}")
        result["ring_attention"] = {"shape": list(PAR_SEQ), **ring}
        result["moe"] = {"dim": dim, "hidden": hidden, "experts": e, "tokens": [mb, tok],
                         "max_abs_err": moe_err,
                         "ms": time_ms(torch, lambda: moe.apply(local, t), PAR_REPS),
                         "dense_ms": time_ms(torch, lambda: moe.apply_dense(mp, t), PAR_REPS)}

        # (d) Predictor(mesh=) on the flagship's fused route
        plain_pred = Predictor(cfg, params, (192, 192, 4), 18, device="cuda", chunk_size=CHUNK,
                               use_fused=True)
        mesh_pred = Predictor(cfg, params, (192, 192, 4), 18, device="cuda", chunk_size=CHUNK,
                              use_fused=True, mesh=mesh)
        plain_pred(frames[:1])
        mesh_pred(frames[:1])
        want_ans, want_movie, t_plain, _ = serve(plain_pred, frames)
        zero_conv_counters(hc, hd)  # ---- the mesh route: counters around it ----
        ans, movie, t_mesh, _ = serve(mesh_pred, frames)
        served = {"fused_encoder_stage": hc.fused_encoder_stage.launches,
                  "fused_decoder": hd.fused_decoder.launches}  # ----------------
        check(all(np.array_equal(a_, w_) for a_, w_ in zip(ans, want_ans))
              and np.array_equal(movie, want_movie), "mesh Predictor peaks differ")
        check_peaks(ans, movie, len(frames), 18)
        result["serving"] = {"frames": len(frames), "mesh_frames_per_s": len(frames) / t_mesh,
                             "plain_frames_per_s": len(frames) / t_plain, "launches": served}
        result["launches"] = {**served, "fused_attention": s1}
        check(all(v > 0 for v in result["launches"].values()),
              f"a kernel never launched on the parallel paths: {result['launches']}")

        # (e) more cards: a 2-rank world against this rank's results
        cards = torch.cuda.device_count()
        if cards >= PAR_RANKS:
            torch.backends.cudnn.allow_tf32 = False
            one = parallel_checks(torch, 1)
            result["ranks"] = PAR_RANKS
            result["world_vs_one_rank"] = parallel_world(torch, PAR_RANKS, one)
        print(f"parallel phase ran {result['ranks']} rank(s) on {cards} card(s)", flush=True)
    finally:
        dist.destroy_process_group()
    result["seconds"] = time.perf_counter() - t_phase
    emit(result)
    return result



def main() -> int:
    import torch

    from pose_estimation_amitai_torch import Config, weights

    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--repeat-train" or not args[1].isdigit()):
        raise SystemExit("usage: chip_smoke.py [--repeat-train N]")
    name, smi = phase_device(torch)
    torch.backends.cudnn.allow_tf32 = False  # cuDNN f32 convs default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    conv_libs = phase_build()
    cfg = Config()
    params = weights.init_basicnet_params(
        np.random.default_rng(SEED), in_channels=4, out_channels=18,
        filters=cfg.num_base_filters,
    )
    frames = np.random.default_rng(SEED).random(
        (sum(REQUESTS), 192, 192, 4), dtype=np.float32)
    movie = movie_frames(frames)
    rows = phase_kernels(torch, params, conv_libs)
    rows.append(ftl_fusion_row(torch))
    sl = phase_slice(torch, cfg, params, frames, movie, name, smi)
    q8 = phase_int8(torch, cfg, params, frames, name, smi)
    im = phase_im2col(torch, name, smi)
    phase_lift(torch)
    vt = phase_vit(torch, frames, movie, name, smi)
    del movie
    phase_vit4cam(torch, name, smi)
    probe_rows = phase_probes(torch, name, smi)
    if args:
        return repeat_train(torch, name, smi, int(args[1]))
    tr = phase_train(torch, name, smi)
    trn = phase_trainer(torch, name, smi, tr["step_ms"])
    ent = phase_entry(torch, name, smi)
    phase_multicam(torch, name, smi)
    zoo = phase_zoo(torch, name, smi)
    vtr = phase_vit_train(torch, name, smi)
    phase_int8_generic(torch, frames, name, smi)
    ss = phase_selfsup(torch, name, smi)
    imp = phase_import(torch, params, frames, name, smi)
    ex = phase_export(torch, params, frames, name, smi)
    par = phase_parallel(torch, params, frames, name, smi)
    launches = {**sl["launches"], **q8["launches"], **vt["launches"],
                "quantized_conv3x3": im["launches"],
                "ftl_fusion": zoo["models"]["FourCamDisentangled"]["served_fused"]
                ["launches"]["ftl_fusion_kernel"]}
    imported = {**{k: v for k, v in imp["launches"]["BasicNet"].items() if v},
                **{k: v for k, v in imp["launches"]["ViT"].items() if v}}
    jax_run = imp["jax_run_directory"]["launches"]  # the JAX run directory (B1, B2)
    keras = imp["keras"]["ViT"]["launches"]  # the keras ViT (S1)
    staged = {**sl["staging"]["movie_launches"], **vt["staging"]["movie_launches"]}
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] in staged:  # the staging movies of distinct frames
            r["movie_launches"] = staged[r["name"]]
            check(r["movie_launches"] > 0, f"{r['name']}: no launch in the staging movie")
        if r["name"] in ex["launches"]:  # the loaded serving artifacts
            r["export_launches"] = ex["launches"][r["name"]]
            check(r["export_launches"] > 0, f"{r['name']}: no launch from a loaded program")
        if r["name"] in ss["served"]["launches"]:  # the pretraining run directory
            r["selfsup_launches"] = ss["served"]["launches"][r["name"]]
        if r["name"] in imported:  # the imported reference checkpoints
            r["import_launches"] = imported[r["name"]]
        if r["name"] in jax_run:
            r["jax_checkpoint_launches"] = jax_run[r["name"]]
        if r["name"] in keras:
            r["keras_launches"] = keras[r["name"]]
        if r["name"] in par["launches"]:  # the parallel phase's serving paths
            r["parallel_launches"] = par["launches"][r["name"]]
            check(r["parallel_launches"] > 0, f"{r['name']}: no launch on the parallel paths")
        if r["name"] in vtr["launches"]:  # the trained ViT's run directory
            r["vit_train_launches"] = vtr["launches"][r["name"]]
        if r["name"] in tr["served"]["launches"]:  # the trained weights' chunk
            r["train_launches"] = tr["served"]["launches"][r["name"]]
            r["trainer_launches"] = trn["served"]["launches"][r["name"]]
            r["entry_launches"] = ent["served"]["launches"][r["name"]]
            check(r["entry_launches"] > 0, f"{r['name']}: no launch on the entry point's run")
    rows += probe_rows
    for r in rows:
        check(r["launches"] > 0, f"{r['name']} never launched on its path")
    emit({"kernels": [{k: v for k, v in r.items() if k != "cases"} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
