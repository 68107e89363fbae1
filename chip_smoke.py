#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (point_dae_torch) on one NVIDIA GPU.

Phases, each fatal on failure:
  1. card   - name and power limit from nvidia-smi;
  2. build  - compile every kernel source of point_dae_torch/csrc with
              nvcc (sm_90a), all at once;
  3. kernels- at the two pretrain steps' shapes, hold each kernel against
              its plain PyTorch version on the card and time kernel, plain
              version and (where one exists) a single PyTorch library call;
  4. check  - one forward of the full-width flagship model at batch 128
              (every kernel gate open) on the card against the same forward
              on the CPU, which takes the plain paths (the paths the CPU
              parity tests hold against the JAX package); the full-width
              DGCNN encoder (the fused kernel) at batch 8 on the card
              against the CPU: in f32 layer by layer against the reference
              EdgeConv (the rows whose two kNN selections agree) and as a
              whole, in bf16 layer by layer against the reference EdgeConv and as a
              whole against the fused layer's plain path, with the loss;
  5. train  - 5 flagship pretrain steps of the default configuration
              (batch 256 from a raw (256, 8192, 6) tensor, trans_dim 384,
              depth 12 + 4, bf16, fold_impl auto) with every launch counter
              zeroed before and read after, one profiled step, then steps
              of a second model with fold_impl xla (the plain folding head)
              beside it; then 5 DGCNN pretrain steps (Point_CAE_DGCNN_FCOnly,
              batch 128 from a raw (128, 8192, 6) tensor, 1024 points, k 20,
              widths 64/64/128/256, bf16, affine_r3 + dropout_local), counters
              zeroed and read the same way, one profiled step, and 2 steps
              with edgeconv_exact_grads (the 'split' backward kernel);
  6. finetune - the classification fine-tune entry of the two shipped
              recipes at full width from random clouds: A, PointTransformer
              (cfgs/finetune_scan_hardest_transferring_features.yaml: batch
              32 of 2048 points, FPS 2048 -> 2048, trans_dim 384, depth 12,
              G 128 x S 32, f32, smooth CE) and B, DGCNN
              (cfgs/finetune_modelnet_transferring_features_1k.yaml: batch
              32 of 8192 points, FPS 1200 then a random 1024, f32, CE); the
              fps kernel against its plain version at the recipes' shapes;
              both models' eval logits and train-mode loss at batch 8 on the
              card against the CPU; 5 train steps of each (counters zeroed
              before, read after), a profiled step, an eval step, a 10-draw
              vote step and the accuracy loop; then 2 steps of A in bf16
              (T 129 keeps the plain attention and MLP, as in JAX);
  7. partseg - the part-segmentation entry at full width from random clouds
              with random categories and per-point labels: PT,
              PointTransformerPartSeg (cfgs/partseg_shapenetpart.yaml: batch
              16 of 2048 points, trans_dim 384, depth 12, G 128 x S 32, 50
              parts, f32) and DGCNN, DGCNNPartSeg (the same recipe); the
              scatter_rows_add kernel (the backward of the row gather)
              against its plain version on the CPU, bit for bit, at both
              models' shapes, with gather_rows_small_c and patchify at
              theirs (kernels phase); both models' eval log-probs and
              train-mode loss at batch 8 (every gate open) on the card
              against the CPU; 5
              train steps of each (counters zeroed before, read after), a
              profiled step, an eval step and the mIoU loop;
  8. dropouts - the in-model dropouts, MaskFeat_dgcnn and the hybrid
              EdgeConv kNN: the key_gather, knn and aggregate_from_idx
              kernels and knn_aggregate at (32, 2048) and (4, 4096) against
              their plain versions (kernels phase); the dropout DGCNN model
              and MaskFeat_dgcnn at batch 8 on the card against the CPU, and
              the dropouts at batch 128 (check phase); the shipped
              ScanObjectNN DGCNN fine-tune at 2048 points as recipe C of the
              finetune phase (check, 5 steps, eval, vote); 2 DGCNN steps with
              edgeconv_knn xla after the hybrid encoder is held bit for bit
              to the fused one; 5 steps of pretrain_PointCAE_dropout_patch_
              pointmae, 2 each of _dropout_global_p3 and _affine_r3_dropout_
              patch_pointmae, 5 of pretrain_MaskSurf_dgcnn_crosspoint
              (MaskFeat_dgcnn), all shipped configs unchanged at bs 128;
  9. memory keys - fused_mlp (forward, backward) at R 16384 and 8192 and
              gather_rows_wide at (16, 2048, 64) by 40960 rows against their
              plain versions (kernels phase); the flagship under
              residual_dtype bf16 at batch 8 on the card against the CPU,
              and remat + remat_fold (f32 and bf16 residual stream) and the
              DGCNN encoder's remat against the runs without them, bit for
              bit (check phase); 5 flagship steps under residual_dtype bf16
              (16 mlp_fwd and mlp_bwd launches a step, no mlp_ln), 2 steps
              each of remat + residual_dtype bf16, remat_fold and
              embed_all_patches, and 2 DGCNN steps with remat, each with its
              step time and peak memory beside the default run's;
 10. redesign - the small-C gather also from int64 indices, bit for bit,
              its device time (torch.profiler) beside torch.gather's from
              the path's int32 index (cast included) and from a ready int64
              one; the attention kernels' registers and shared memory, and
              fused_attention at three gate shapes off the models' path
              (T 40 d 32 masked, T 128 d 64, T 256 d 128) against its plain
              version (kernels phase); the mlp_ln and mlp kernels at C
              512, 768 and 1024 (H 4 C) against their plain versions at R
              256 and timed at R 16384;
 11. folding redesign - the fused folding backward's device time split
              by launch (rows pass, weights pass, small products, sums) and
              the forward's, two backward calls held bit for bit, the plain
              fold_impl xla head's forward + backward device time beside the
              fused head's (the head's yardstick), and F 512 (one-block
              form) and F 640 (wide form) at 256 tokens against the plain
              version (kernels phase); gather_rows_wide from an int32 and an
              int64 index, rows out of range included, bit for bit, its
              device time beside torch.gather's (kernels phase); the
              profiled flagship step prints the folding kernels' total.
 12. MLP backward redesign - both MLP backwards (five wgmma GEMMs) at R
              16384 and 8192 against their plain twins mlp_ln_bwd_plain and
              mlp_bwd_plain (each output within 5e-3 of its largest value),
              two calls bit for bit, the device time split by launch (rows
              in, dual, dxin, weights, LN rows, sums), TFLOP/s over the five
              products beside the same five products through torch.matmul
              (the yardstick; the port never calls it), the plain twin's
              time; the backward at C 512, 768 and 1024 beside its plain
              twin; the build prints the mlp kernels' registers
              and spills; the profiled steps split the mlp_ kernels' total
              into forward and backward; the flagship step must launch
              mlp_ln 16 times a step.
 13. EdgeConv and FPS redesign - the previous EdgeConv design
              (point_dae_torch/tools/edgeconv_parent.cu) is built beside the
              kernels; at the DGCNN step's four shapes the redesigned
              selection's idx and both backwards' du are held bit for bit
              against it, each launch's device time is printed (selection,
              aggregate; tie weights, counting sort, sums), and torch.topk
              over torch.cdist is the forward's library time, beside the
              distances' rounding-rule floor; at (32, 2048) and (4, 4096) the
              same device split beside the plain versions; fps at 16384
              points (the streamed form). A profiler window that lost more
              than 5% of its kernel records (against its launch records) is
              taken again, and three such windows in a row fail the run,
              naming the function they timed.
 14. MLP forward redesign - both MLP forwards (LN rows for mlp_ln, then
              two wgmma GEMMs over a bf16 hidden) at R 16384 and 8192 and at
              C 512, 768 and 1024 against their plain versions (the branch
              within 5e-3 of its largest value), two calls bit for bit, the
              device time split by launch (LN rows, hidden, out), TFLOP/s
              over the two products beside the same two products through
              torch.matmul (the yardstick; the port never calls it).
 15. FPS and patchify redesign - the previous FPS and patchify designs
              (point_dae_torch/tools/fps_parent.cu, patchify_parent.cu) are
              built beside the kernels; fps at the fine-tune shapes under
              its plan (ops/fps.py:plan: clusters of four blocks at 8192
              points, one block at 2048 and fewer) and at (32, 8192) -> 1200
              also under clusters of 2 and 8 blocks and one block, picks bit
              for bit with the plain version and the previous design, each
              time beside the previous design's; patchify at (256, 1024) G
              64 and at (16 and 32, 2048) G 128, fps_idx and knn_idx bit for
              bit with the previous design, its device time by launch (the
              FPS launch, the kNN rows launch). A profiler window of a
              library yardstick (torch.gather, torch.matmul, SDPA) lost
              PROFILE_WINDOWS times in a row is logged and the yardstick's
              device time and library_ms are reported as null; the port's
              own kernels' windows still fail the run.
 16. aggregate and scatter redesign - the previous aggregate and scatter
              designs (point_dae_torch/tools/aggregate_parent.cu,
              scatter_parent.cu) are built beside the kernels; at the DGCNN
              step's four EdgeConv shapes, at (32, 2048) and at (4, 4096)
              the aggregate alone (the staged form under
              ops/edgeconv.py:aggregate_plan) bit for bit against the
              previous design with track on and off, each design's device
              time and the bound by bytes; scatter_rows_add at the three
              partseg cases bit for bit against the previous design, its
              device time split into count, place and sums beside the
              previous design's sort and sums.
 17. chamfer redesign - the previous chamfer design
              (point_dae_torch/tools/chamfer_parent.cu, a launch a direction)
              is built beside the kernels; the patch chamfer at the
              flagship's 13056 patches of 36 and 32 points and the tiled
              chamfer at the DGCNN step's (128, 1024, 1024), each both
              directions in one launch under its plan
              (losses/chamfer.py:patch_plan, tiled_plan): dist, idx and near
              bit for bit with the two plain halves and the previous design,
              each design's time a call and device time, the bound (the
              patch half's by bytes read once and twice; the tiled half's
              rounding-rule floor); each train step launches each chamfer
              kernel once; key_gather's device time beside its wrapper's.
 18. key gather redesign - the key gather (csrc/gather.cu:
              gather_by_key_small_c) at both dropout shapes from int64 keys
              and ranks, from the mask with f32 uniforms and with int64
              ranks, and through resample_batch, each bit for bit with its
              plain twin (key_gather_report); a masked resample_batch is
              one kernel launch under torch.profiler (launches_a_call);
              its call time, each form's device time and bound; the
              dropout_patch_pointmae and dropout_global_p3 steps each
              profiled (busy time). Its previous design is timed by
              point_dae_torch/tools/key_gather_ablation.py, not here.
 19. corruption families and the unmasked flagship - every cloud family
              of corrupt_batch (each alone at the DGCNN pipeline's (128,
              8192), and three shipped pairs), the augmentations and every
              patch family of corrupt_patches at (256, 64, 32, 3) on the card
              against the CPU with the same draws: points within 1e-5, masks
              equal but for flips of a strict compare within 1 ulp (counted),
              the resample to 1024 (phase corruptions_check); then 5 steps of
              pretrain_PointCAE_random_add_affine_r3, _affine_r5_v2_dropout_
              local_c5d3, _transformer_add_local (unmasked, f32; shipped
              configs unchanged, bs 128) and FLAGSHIP_CONFIG with model
              corrupt_type ['add_local'] (unmasked, bf16, bs 256), each first
              checked at a small batch against the CPU, with step time, busy
              time and peak memory; the bf16 run must launch attention and
              mlp_ln 16 times a step each at T 64 and R 16384, folding over
              16384 tokens and the patch chamfer over 16384 pairs (phase
              corrupt_train).
 20. run     - the data and run layer through the port's CLI
              (point_dae_torch.cli.main) in process, in a temporary
              directory, after the partseg phase, every launch counter
              zeroed before it: cfgs/pretrain_synthetic_flagship_cached.yaml
              at full width (bs 256, float16 device cache) with max_epoch 1
              and 768 Synthetic clouds (3 steps an epoch), its overrides
              written into a copy and printed; cfgs/pretrain_synthetic_dgcnn
              .yaml as shipped (streaming loader, SVM probe each epoch), then
              again with --resume and max_epoch 6, which must continue at
              epoch 5 from the saved step; a full-width PointTransformer
              fine-tune on Synthetic warm-started with --ckpts from the
              flagship's ckpt-last.pth (the warm start must merge tensors),
              then --test --vote from its ckpt-best.pth (RUN_VOTE_REPEATS
              voting passes, of the CLI's 299);
              one epoch of cfgs/partseg_shapenetpart.yaml on a ShapeNetPart
              tree of random shapes written there, then --test from its
              best_model.pth. Fatal: a raised exception, a non-finite loss, a
              missing [Training] EPOCH or [Validation] EPOCH line or
              checkpoint, a resume that does not continue, a counter of the
              paths (the flagship's, the DGCNN's, fps, scatter_rows_add) at 0.
              Printed beside the card: each run's clouds/s over its loop
              (host clock, loader or device cache included, first epoch
              apart), each configuration's busy time in one profiled step,
              and the LinearSVC probe's seconds at ModelNet40's size (9843 x
              F train, 40 classes) on the card at F 384 and 1024 and on the
              host CPU at F 384.
 21. m2ae    - the Point-M2AE family at full width from random (128, 8192,
              6) clouds with unit normals resampled to 2048 points: fps at
              (128, 2048) -> 512 and (128, 512) -> 256, the kNN selection
              (256 queries into 512 centres, k 8), the small-C gather of
              both xyz groups, the scatter-add of the scale-1 merge's and
              three_interpolate's backwards, the patch chamfer (32768 pairs
              of 16 and 8) and the MDAE head's tiled chamfer (128, 512,
              512) against their plain versions, bit for bit; Point_M2AE
              (cfgs/pretrain_PointM2AE.yaml as shipped) and
              Point_MDAE_with_fc_center_p with ['affine_r3', 'Drop-Patch']
              each on the card against the CPU at bs 32 (losses within 1e-4
              relative), then 5 and 2 steps at bs 128 with each kernel's
              launches a step held to M2AE_RUNS, a profiled step's busy
              time, the step time and peak memory; the M2AE fine-tune
              (cfgs/finetune_scan_hardest_tf_pointm2ae.yaml, bs 32 of
              2048): eval logits against the CPU, 5 train steps, a profiled
              one, an eval and a 10-draw vote step, launches held;
 22. probe   - fps at (64, 1024) and (64, 2048) and DGCNN_feat's first
              EdgeConv forward at (64, 1024) against their plain versions;
              then --svm_classification with DGCNN_feat and with
              Point_M2AE_SVMFeature and --task_affinity with DGCNN_feat
              through point_dae_torch.cli.main on Synthetic clouds at a
              quarter of ModelNet40's split sizes (PROBE_SET: 2483 / 612,
              40 classes, the configs' npoints):
              each run's log lines, extraction seconds and launches, each
              SVC fit's SMO iterations and seconds, the head's seconds;
              then the port's SVC fitted on the card and on the host CPU
              over 8 classes of the M2AE features, predictions equal.
 23. backbones - fps at (128, 1024) -> 64, (32, 1024) -> 512 and (32,
              512) -> 128, the small-C gather of the ball queries' xyz
              groups (3DETR's and both PointNet++ levels'), the row
              scatter-add of PointNet++'s sa2 feature gather, the patch
              chamfer over 3DETR's 6528 masked patches and patchify at
              (128, 1024) G 64 and (32, 2048) and (32, 8192) G 128 against
              their plain versions (zoo_kernels); then 3DETR
              (PointCAE_transformer_fc_global_fc_local_3detr), Point_MAE
              and MaskFeat_transformer, each from its shipped config at bs
              128 from (128, 8192, 6) raw clouds: the train-mode losses on
              the card against the CPU (1e-4 relative), 3 steps with every
              launch counter a step held to BACKBONE_RUNS, a profiled
              step's busy time, the step time and peak memory; 3DETR's
              pretrain through the CLI on Synthetic clouds (SVM probe
              through encode);
 24. part modes - the linear probe and the non-linear head under
              optimizer.part only_new, the diff_lr fine-tune (bs 32 of
              2048) and PointNetv2 (bs 32 of 1024), each from its shipped
              config: eval logits on the card against the CPU (1e-4 of the
              largest), 3 train steps with every launch counter a step held
              to PART_RUNS (under only_new only cls tensors move, BatchNorm
              statistics included), a profiled step; then the linear probe
              through the CLI on Synthetic clouds, after which only
              cls.weight and cls.bias differ from the initial weights.
 25. downstream - Point_MlMAE from cfgs/pretrain_PointMlMAE.yaml at bs
              128: its losses at batch 8 on the card against the CPU (1e-4
              relative), 5 steps with every launch counter a step held,
              a profiled step; the rotation protocol: a so3 train step's
              logits at batch 8 on the card against the CPU (1e-3 of the
              largest), train and eval steps at bs 32 timed, both shipped
              protocol configs through --so3_rotation on Synthetic clouds;
              the ModelNet-C battery: one cell a family on the card against
              the CPU (index sets equal, clouds within 1e-5), then
              --test_corruption through the CLI on 256 Synthetic clouds
              (the generated path, every cell's seconds); --vis_saliency
              through the CLI (8 .npz files; gradients against the
              EdgeConv kernels' plain versions on the card within 1e-3 of
              the largest, logits against the CPU within 1e-3, the
              gradients' gap to the CPU printed); reconstruct of the bf16 flagship
              and of MaskSurf_v2_token_dis on the card against the CPU (2%
              and 1e-4), timed at the configs' total_bs, then --test
              through the CLI (16 samples with their renders); each kernel
              of these paths launched on each of them.
 26. cnn zoo - the PointNet, PointNet++ and DGCNN DAEs (phase_cnn_zoo).
 27. transformer heads - the patch chamfer over the v6 heads' 16384 pairs
              of 32 and 32 points and the tiled chamfer at (256, 1024) x
              (256, 1024) against their plain halves, bit for bit; the 13
              PointCAE heads on FLAGSHIP_CONFIG's path with model.NAME
              replaced (bs 256, bf16; the v6 heads unmasked): five on the
              card against the CPU at batch 128 (2%), 5 steps of each with
              its launches a step held to HEADS_RUNS (no folding kernel),
              the step time, a profiled step's busy time and the peak
              memory; the bnmscheduler's re-blend on the card; the
              supervised pretrain and the DGCNN recipe under LambdaLR,
              step_per_update 2 and a bnmscheduler through the CLI on
              Synthetic clouds (phase_transformer_heads).
 28. parallel - data parallelism (point_dae_torch/parallel/mesh.py), each
              rank a child process of this script whose one JSON line the
              parent reads; a child that fails, or a group that does not
              form, fails the run (no fallback): (a) FLAGSHIP_CONFIG (bs
              256, raw (256, 8192, 6)) 5 steps with no group, then in the
              same child 5 steps under an nccl group of one (the gradient
              all-reduce on), PyTorch's deterministic mode on for both: the
              losses bit for bit, the step times side by side, the
              all-reduce's ms a step timed alone, each of the flagship's
              six kernels launched in the group's run; (b) 2 steps of two
              gloo ranks on the one card (bs 128 each, Synthetic clouds
              through the row-split loader) against one process at bs 256,
              products in f32: the global batches' hashes equal, step-1
              losses within 2e-5, step-2 within 5e-3
              (tests/test_multihost.py's contract); then with the bf16
              products (the kernels' path), step 1 within 1e-4; (c)
              DGCNN_CONFIG in f32, 2 x 64 against 128, step 1 within 1e-4,
              step 2 within 5e-3 (PAR_PAIRS says why); in every set the
              BatchNorm running statistics after step 1 within PAR_BN_TOL
              of one process's and the two ranks' final parameters and
              buffers bit for bit equal; (d) emd_loss and its gradients at
              (32, 1024, 3) on the card against the CPU (the loss within
              1e-5, the gradients 1e-3 of their largest; emd_check says
              why), timed (phase_parallel). ``python3 chip_smoke.py
              --parallel-readings`` prints what (b) and (c) read, beside
              one process against itself with its batch's rows reversed
              and under each of PAR_FAULTS (a group broken on purpose),
              and which checks each fault fails.
 29. tensor_parallel - tensor parallelism (parallel/mesh.py: get_mesh_2d,
              shard_params): fused_attention at a rank's share of the
              heads, (256, 32, 3, 64) masked and (256, 64, 3, 64), against
              its plain version and timed (the kernels line's
              attention_fwd_h3 and attention_bwd_h3); then FLAGSHIP_CONFIG
              (bs 256, 12 + 4 blocks of 384, 6 heads) on two gloo ranks
              sharing the card at tp 2 (dp 1), each a child process
              (--parallel-child with a "tp" spec), against one process from
              the same weights, raw batch and draws: in bf16 for TP_STEPS
              steps, losses within TP_BF16_TOLS (step 1, step 2; step 3
              printed), and in f32 for TP_F32_STEPS steps within
              TP_F32_TOLS; in both the whole parameters after step 1
              (gather_params) within two AdamW steps and TP_PARAM_SHARE of
              their elements within TP_PARAM_ATOL, in f32 AdamW's first
              moments (the clipped gradient) within TP_F32_GRAD_TOL, the
              two ranks' losses and replicated tensors bit for bit; the
              attention kernel run at
              H 3 and mlp_ln on the gathered (384, 1536) weights, every
              flagship counter above 0; one bf16 step with
              reduce_from_model dropped must fail the step-1 check, one f32
              step with copy_to_model dropped the moments' check; a
              rank's bf16 step on the host clock, then one more step with
              the model group's all-reduces counted (phase_tensor_parallel).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Run from the repository root:

    python3 chip_smoke.py
"""
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 0
BATCH, NRAW = 256, 8192
CHECK_BATCH = 128          # smallest batch at which every kernel gate opens
TRAIN_STEPS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor cores
F32_FLOPS = 67e12          # f32 outside the tensor cores

XLA_STEPS = 5              # steps of the fold_impl xla model run beside the default
DGCNN_BATCH = 128
DGCNN_CHECK_BATCH = 8
EXACT_STEPS = 2            # DGCNN steps with edgeconv_exact_grads
FLAGSHIP_COUNTERS = ("patchify", "gather_rows_small_c", "nn_half_small", "mlp_ln_fwd",
                     "mlp_ln_bwd", "folding_fwd", "folding_bwd", "attention_fwd",
                     "attention_bwd")
DGCNN_COUNTERS = ("nn_half_tiled", "knn_aggregate_fwd", "knn_aggregate_bwd_first")
MEM_CHECK_BATCH = 8        # smallest batch at which the mlp gate opens in both stacks
MEM_STEPS = 2              # steps of each further memory-key configuration
RESIDUAL_BF16 = {"residual_dtype": "bf16"}
MEM_VARIANTS = (           # transformer_config keys, each run beside the default
    ("remat + residual_dtype bf16", {"remat": True, "residual_dtype": "bf16"}),
    ("remat_fold", {"remat_fold": "True"}),
    ("embed_all_patches", {"embed_all_patches": True}))
FLAGSHIP_CONFIG = {        # __graft_entry__.FLAGSHIP_CONFIG at bs 256
    "optimizer": {"type": "AdamW", "part": "all",
                  "kwargs": {"lr": 0.001, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
    "dataset": {"train": {"others": {
        "subset": "train", "npoints": 1024, "aug_type": ["norm"],
        "corrupt_type": ["clean"], "whole": True}}},
    "model": {
        "NAME": "PointCAE_transformer_fc_global_folding_local",
        "corrupt_type": ["affine_r3", "Drop-Patch"],
        "all_patch": "False", "group_size": 32, "num_group": 64, "loss": "cdl2",
        "transformer_config": {
            "rand_ratio": "True", "mask_ratio": 0.6, "mask_type": "rand",
            "trans_dim": 384, "encoder_dims": 384, "depth": 12,
            "drop_path_rate": 0.1, "cls_dim": 55, "num_heads": 6,
            "decoder_depth": 4, "decoder_num_heads": 6,
            "dtype": "bf16"}},
    "normal_weight": 0.005, "npoints": 1024, "total_bs": BATCH,
    "step_per_update": 1, "max_epoch": 300, "loss_type": "xyznormal",
}
DGCNN_CONFIG = {           # bench.py's DGCNN line: the released recipe's shapes
    "optimizer": {"type": "AdamW", "part": "all",
                  "kwargs": {"lr": 0.001, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 1200, "initial_epochs": 10}},
    "dataset": {"train": {"others": {
        "npoints": 1024, "aug_type": ["norm"],
        "corrupt_type": ["affine_r3", "dropout_local"]}}},
    "model": {"NAME": "Point_CAE_DGCNN_FCOnly",
              "corrupt_type": ["affine_r3", "dropout_local"],
              "loss": "cdl2", "dtype": "bf16"},
    "npoints": 1024, "total_bs": DGCNN_BATCH, "step_per_update": 1,
    "max_epoch": 1200, "loss_type": "xyznormal_gradual",
}
FT_BATCH, FT_CHECK_BATCH, FT_STEPS, FT_BF16_STEPS, VOTE_TIMES = 32, 8, 5, 2, 10
FT_OPTIM = {"optimizer": {"type": "AdamW", "part": "all",
                          "kwargs": {"lr": 0.0005, "weight_decay": 0.05}},
            "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
            "total_bs": FT_BATCH, "step_per_update": 1, "max_epoch": 300,
            "grad_norm_clip": 10}
FINETUNE_A = dict(FT_OPTIM, npoints=2048, model={   # finetune_scan_hardest_transferring_features
    "NAME": "PointTransformer", "trans_dim": 384, "depth": 12, "drop_path_rate": 0.1,
    "cls_dim": 15, "num_heads": 6, "group_size": 32, "num_group": 128,
    "encoder_dims": 384})
FINETUNE_B = dict(FT_OPTIM, npoints=1024,           # finetune_modelnet_transferring_features_1k
                  model={"NAME": "DGCNN", "cls_dim": 40})
# (config, raw points a cloud (ScanObjectNN_hardest: 2048; ModelNet40Official:
# 8192), smooth loss as tools/bench_downstream.py runs each)
FINETUNES = {"A": (FINETUNE_A, 2048, True), "B": (FINETUNE_B, 8192, False)}
# C, the ScanObjectNN DGCNN fine-tune at 2048 points, joins in main() from
# FINETUNE_C_CFG (cfgs/generated/, unchanged)
# kernels each fine-tune recipe's profiled step must show (A's, fps and
# patchify, are its first and are missed: see phase_finetune)
FT_PROFILED = {"A": (), "B": ("knn_select_kernel", "edgeconv_bwd_kernel"),
               "C": ("knn_select_kernel", "edgeconv_bwd_kernel")}
FT_COUNTERS = {"A": ("fps", "patchify"), "C": ("fps", "knn_aggregate_fwd", "knn_aggregate_bwd_first"),
               "B": ("fps", "knn_aggregate_fwd", "knn_aggregate_bwd_first")}
PS_BATCH, PS_CHECK_BATCH, PS_STEPS, PS_POINTS = 16, 8, 5, 2048
PARTSEG_PT = {             # cfgs/partseg_shapenetpart.yaml, unchanged
    "optimizer": {"type": "AdamW", "part": "all",
                  "kwargs": {"lr": 0.0002, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 300, "initial_epochs": 10}},
    "dataset": {
        "train": {"_base_": "cfgs/dataset_configs/ShapeNetPart.yaml",
                  "others": {"subset": "trainval", "npoints": 2048}},
        "test": {"_base_": "cfgs/dataset_configs/ShapeNetPart.yaml",
                 "others": {"subset": "test", "npoints": 2048}}},
    "model": {"NAME": "PointTransformerPartSeg", "trans_dim": 384, "depth": 12,
              "drop_path_rate": 0.1, "cls_dim": 50, "num_heads": 6, "group_size": 32,
              "num_group": 128, "encoder_dims": 384},
    "npoints": 2048, "total_bs": PS_BATCH, "max_epoch": 300, "grad_norm_clip": 10,
}
PARTSEG_DGCNN = dict(PARTSEG_PT, model={"NAME": "DGCNNPartSeg", "cls_dim": 50})
# (config, scatter_rows_add launches a step, kernels its forward launches;
# at PS_CHECK_BATCH 8 the gates of both are open: 8 x 40960 rows >= 2^18)
PARTSEGS = {"PT": (PARTSEG_PT, 1, ("patchify",)),
            "DGCNN": (PARTSEG_DGCNN, 2, ("gather_rows_small_c",))}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn, CUDA events, after two warm-ups."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_us(e) -> float:
    """Device microseconds of a torch.profiler event (the attribute's name
    moved between torch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


PROFILE_WINDOWS = 3        # windows a device time may take before the run fails
# A profiler window loses the kernel records of its first few launches
# (about five): a profiled step's window misses four to five records, its
# first kernels among them, and a window of five fps calls opened right
# after one held none or one of them, behind a single 10 ms primer kernel
# too. So each window first launches PRIMER_LAUNCHES short
# torch.cuda._sleep kernels (about 10 ms in all at 1.98 GHz), waits for
# them, and leaves those kernels and their launches out of what it counts.
PRIMER_LAUNCHES = 32
PRIMER_CYCLES = 20_000_000 // PRIMER_LAUNCHES
PRIMER_KERNEL = "spin_kernel"


def prime_profiler(torch) -> None:
    for _ in range(PRIMER_LAUNCHES):
        torch.cuda._sleep(PRIMER_CYCLES)
    torch.cuda.synchronize()


def launch_balance(records, kernels):
    """(kernel records, launch records) of a profiler window: a kernel's
    activity record against the cudaLaunchKernel or cuLaunchKernel record
    of its launch (copies and sets have records of their own and count as
    neither); the primer's launches are left out."""
    launched = sum(e.count for e in records
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    recorded = sum(e.count for e in kernels if not e.key.startswith(("Memcpy", "Memset")))
    return recorded, max(launched - PRIMER_LAUNCHES, 0)


def window_kernels(torch, records):
    """The kernel records of a profiler window (annotations and operator
    records repeat their kernels' time), the primer left out."""
    return [e for e in records
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False) and PRIMER_KERNEL not in e.key]


def per_call_ms(us: float, count: int, calls: int) -> float:
    """Device ms a call of a kernel with ``count`` records of ``us`` in all
    over ``calls`` calls: its mean times its launches a call where it runs
    in every call (a lost record then moves nothing), else the total over
    the calls."""
    per = round(count / calls)
    if per >= 1 and count >= per * calls - 1:
        return us / count * per / 1e3
    return us / calls / 1e3


def kernel_events(fn, calls: int, what: str, library: bool = False):
    """The kernels torch.profiler records over ``calls`` calls of fn, after
    one warm-up: [(name, device ms a call)], annotations left out (they
    repeat their kernels' time). A kernel's time a call is its records'
    mean times its launches a call, so that a record the profiler lost
    (one of 50 at a window's edge, in some windows) moves nothing. A window
    can lose more: the T 64 attention forward's whole window once, four of
    a fine-tune fps kernel's five records. A window holding fewer than 95%
    as many kernel records as launch records is logged and taken again,
    and when PROFILE_WINDOWS windows in a row fall short the run fails,
    naming ``what``; but for a ``library`` yardstick (a PyTorch call the
    port never makes, timed beside a kernel) it logs the loss and returns
    None, and its device time and library_ms are reported as null."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prime_profiler(torch)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        records = prof.key_averages()
        events = window_kernels(torch, records)
        recorded, launched = launch_balance(records, events)
        if events and recorded >= 0.95 * launched:
            return [(e.key, per_call_ms(dev_us(e), e.count, calls)) for e in events]
        log(f"  profiler window {attempt} of {what} holds {recorded} kernel records of "
            f"{launched} launches")
    if library:
        log(f"  torch.profiler lost {PROFILE_WINDOWS} windows in a row of {what}, a library "
            f"yardstick: its device time and library_ms are reported as null")
        return None
    fail(f"device time of {what}: {PROFILE_WINDOWS} torch.profiler windows in a row lost "
         f"kernel records")


def device_ms(fn, what: str, calls: int = 50, library: bool = False):
    """Device milliseconds a call of fn: the time of every CUDA kernel
    torch.profiler records a call (``kernel_events``), summed; and the
    kernels' names. Fails the run, naming ``what``, when the profiler
    loses the window's kernels; for a ``library`` yardstick returns (None,
    []) instead."""
    events = kernel_events(fn, calls, what, library)
    if events is None:
        return None, []
    return sum(ms for _, ms in events), sorted(key[:40] for key, _ in events)


def ms_text(v) -> str:
    """A device time, or "null" where the profiler lost a library window."""
    return "null" if v is None else f"{v:.4f}"


def gather_times(torch, x, idx):
    """The small-C gather's times beside torch.gather's at one shape, idx
    int32 as the paths give it: per call on the host clock's view (CUDA
    events over back-to-back eager calls) and on the device (kernel time
    under the profiler). torch.gather is timed from the same int32 index,
    its cast to int64 included (like for like), and from an int64 index
    made ready beforehand."""
    from point_dae_torch.ops import gather

    C = x.shape[-1]
    ready = idx.long()[..., None].expand(-1, -1, C)

    def lib_cast():
        return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, C))

    def lib_ready():
        return torch.gather(x, 1, ready)

    def kernel():
        return gather.gather_rows_small_c(x, idx)

    out = dict(ms=cuda_ms(kernel, 50), lib_cast_ms=cuda_ms(lib_cast, 50),
               lib_ready_ms=cuda_ms(lib_ready, 50),
               plain_ms=cuda_ms(lambda: gather.gather_rows_small_c_plain(x, idx), 50))
    for k, fn in (("dev", kernel), ("lib_cast_dev", lib_cast), ("lib_ready_dev", lib_ready)):
        out[k], out[k + "_kernels"] = device_ms(fn, f"gather_times {k} at {tuple(x.shape)}",
                                                library=k != "dev")
    return out


def gather_line(t) -> str:
    return (f"{t['ms']:.4f} ms a call, device {t['dev']:.4f} ms; torch.gather from the int32 "
            f"index (cast included) {t['lib_cast_ms']:.4f} ms a call, device "
            f"{ms_text(t['lib_cast_dev'])} ms ({len(t['lib_cast_dev_kernels'])} kernels); from a "
            f"ready int64 index {t['lib_ready_ms']:.4f} ms, device "
            f"{ms_text(t['lib_ready_dev'])} ms; "
            f"plain {t['plain_ms']:.4f} ms")


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-12)


MLP_LN_GRADS = ("dx", "dgamma", "dbeta", "dk1", "db1", "dk2", "db2")
MLP_GRADS = ("dx", "dk1", "db1", "dk2", "db2")
# A kernel backward against its plain twin with round_out=False: the f32 sum
# order, the flips of dh's bf16 rounding it causes, and for the bf16 outputs
# their own rounding (at most half a step, 2^-9 of the value).
MLP_BWD_TOL = 5e-3
MLP_BWD_SPLIT = (("rows in", "mlp_bwd_rows_in_kernel"), ("dual", "mlp_bwd_dual_kernel"),
                 ("dxin", "mlp_bwd_dx"), ("weights", "mlp_bwd_weights_kernel"),
                 ("LN rows", "mlp_bwd_ln_rows_kernel"), ("sums", "mlp_bwd_sums_kernel"))
# A kernel forward against its plain version, over the largest value of the
# MLP branch (mlp_ln: y - x): both round the hidden to bf16 at the same
# points, so what is left is the f32 sum order and erff against torch.erf,
# which now and then move one bf16 rounding of the hidden (or of LN(x)) by
# one step, one term of a sum of H (or C) terms.
MLP_FWD_TOL = 5e-3
MLP_FWD_SPLIT = (("LN rows", "mlp_fwd_ln_rows_kernel"), ("hidden", "mlp_fwd_hidden_kernel"),
                 ("out", "mlp_fwd_out_kernel"))


# Each direction's launches (device_split's names), the launches that run its
# products, and its products as (A's shape, B's shape, A transposed, B
# transposed) over (R, C, H): torch.matmul runs the same products on bf16
# operands as the yardstick.
MLP_DIRECTIONS = {
    "forward": (MLP_FWD_SPLIT, ("hidden", "out"),
                lambda R, C, H: (((R, C), (C, H), False, False),
                                 ((R, H), (H, C), False, False))),
    "backward": (MLP_BWD_SPLIT, ("dual", "dxin", "weights"),
                 lambda R, C, H: (((R, C), (C, H), False, False),
                                  ((R, C), (H, C), False, True),
                                  ((R, H), (C, H), False, True),
                                  ((R, C), (R, H), True, False),
                                  ((R, H), (R, C), True, False))),
}


def mlp_report(torch, name, direction, call, R, C, H, device, plain=None, iters=20):
    """One direction of an MLP kernel (``call()``, the raw mlp_ln or mlp
    forward or backward) at R rows: two calls held bit for bit, its time a
    call (CUDA events) and its device time split by launch (torch.profiler),
    TFLOP/s over its products, and the same products through torch.matmul on
    bf16 operands of the same shapes (the products' yardstick; the port never
    calls it); ``plain()``'s time beside it where given."""
    split_names, prod_keys, products = MLP_DIRECTIONS[direction]
    products = products(R, C, H)
    one, two = call(), call()
    one, two = ((one,), (two,)) if torch.is_tensor(one) else (one, two)
    if not all(torch.equal(a, b) for a, b in zip(one, two)):
        fail(f"{name} {direction} at R {R}: two calls on the same inputs differ")
    del one, two
    ms = cuda_ms(call, iters)
    split = device_split(call, split_names, calls=10, what=f"{name} {direction} at R {R}")
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    ops = [tuple(torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
                 for shape in (a, b)) for a, b, _, _ in products]

    def yardstick():
        return [(a.t() if ta else a) @ (b.t() if tb else b)
                for (a, b), (_, _, ta, tb) in zip(ops, products)]

    lib_ms = cuda_ms(yardstick, iters)
    lib_dev, _ = device_ms(yardstick, f"{name} {direction} yardstick (torch.matmul) at R {R}",
                           calls=10, library=True)
    flops = sum(2 * a[0] * a[1] * (b[0] if tb else b[1]) for a, b, _, tb in products)
    prods = sum(split[k] for k in prod_keys)
    plain_ms = cuda_ms(plain, 5) if plain is not None else None
    n = len(products)
    note = (f"device {split['total']:.4f} ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items() if k != "total" and v)
        + f"; {flops / split['total'] / 1e9:.1f} TFLOP/s over the {n} products "
        f"({flops / max(prods, 1e-9) / 1e9:.1f} in their {len(prod_keys)} launches); "
        f"torch.matmul's {n} products {lib_ms:.4f} ms, device {ms_text(lib_dev)} "
        f"({'null' if lib_dev is None else f'{flops / lib_dev / 1e9:.1f}'} TFLOP/s); two calls "
        f"bit for bit")
    log(f"  {name} {direction} at R {R}, C {C}, H {H}: {ms:.4f} ms a call"
        + (f" (plain {plain_ms:.4f})" if plain is not None else "") + f"; {note}")
    return dict(ms=ms, plain_ms=plain_ms, note=note)


def relu_flips_ok(got, want, tol=2e-2, flip_tol=1e-1, flip_frac=1e-4) -> bool:
    """The folding head's bound: error over the plain version's largest
    magnitude within ``tol`` (bf16 operands: 2^-8 a rounding, summed), except
    that at most ``flip_frac`` of a tensor's elements may reach ``flip_tol``:
    where an f32 sum lands on the other side of zero in its last bit, a ReLU
    mask switches one cotangent element on or off, which moves that token's
    dx by about a hundredth of the largest dx (36 x 384 terms a token)."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs() / (float(want.abs().max()) + 1e-12)
    return float(err.max()) <= flip_tol and float((err > tol).float().mean()) <= flip_frac


PATCHIFY_SPLIT = (("fps", "patchify_fps_"), ("knn rows", "patchify_knn_"))
# csrc/chamfer.cu's kernels against whatever else a call launches
CHAMFER_SPLIT = (("kernels", "nn_half"),)
# issue rates of the tiled chamfer's rounding-rule floor (eight instructions a
# pair, 128 lanes a clock an SM): the H100 SXM's boost clock and a clock
# under full load (the card's clock is not set by this script)
CLOCKS_HZ = (1.98e9, 1.755e9)


def chamfer_report(torch, x, y, small, parent, what):
    """Both directions of one chamfer kernel at a path's shape, one launch
    (``nn_half_small_pair`` or ``nn_half_tiled_pair``): every output bit for
    bit with the two plain halves and with the previous design (``parent``,
    built from point_dae_torch/tools/chamfer_parent.cu: a launch a
    direction); each design's time a call (CUDA events) and device time
    (torch.profiler; the previous design's a yardstick, null where its
    windows are lost). Returns (ms, device split, previous ms, previous
    device ms)."""
    from point_dae_torch.losses import chamfer
    from point_dae_torch.tools import chamfer_ablation

    pair = chamfer.nn_half_small_pair if small else chamfer.nn_half_tiled_pair
    plain = chamfer.nn_half_small_plain if small else chamfer.nn_half_tiled_plain
    got = pair(x, y)
    want = plain(x, y) + plain(y, x)
    prev = chamfer_ablation.parent_pair(parent, x, y, small)
    torch.cuda.synchronize()
    for i, (a, b, c) in enumerate(zip(got, want, prev)):
        if not torch.equal(a, b):
            fail(f"{what}: output {i} differs from the plain halves (max |diff| "
                 f"{float((a.float() - b.float()).abs().max())})")
        if not torch.equal(a, c):
            fail(f"{what}: output {i} differs from the previous design")
    del got, want, prev
    ms = cuda_ms(lambda: pair(x, y), 20)
    split = device_split(lambda: pair(x, y), CHAMFER_SPLIT, 20, what)
    previous = lambda: chamfer_ablation.parent_pair(parent, x, y, small)  # noqa: E731
    prev_ms = cuda_ms(previous, 20)
    prev_dev, _ = device_ms(previous, f"previous design of {what}", 20, library=True)
    return ms, split, prev_ms, prev_dev


def patchify_report(torch, pts, G, S, parent):
    """The patchify kernel at (B, N), G, S against the previous design
    (``parent``, built from point_dae_torch/tools/patchify_parent.cu): fps_idx
    and knn_idx bit for bit; its time a call beside the parent's, and its
    device time by launch (the FPS launch, the kNN rows launch). Returns
    (fps_idx, knn_idx, ms a call, line)."""
    from point_dae_torch.ops import fps, patchify
    from point_dae_torch.tools import fps_ablation

    B, N, _ = pts.shape
    fk, kk = patchify.fused_patchify(pts, G, S)
    fq, kq = fps_ablation.parent_patchify(parent, pts, G, S)
    torch.cuda.synchronize()
    if not (torch.equal(fk, fq) and torch.equal(kk, kq)):
        fail(f"patchify at ({B}, {N}), G {G}: fps_idx or knn_idx differs from the previous "
             f"design")
    ms = cuda_ms(lambda: patchify.fused_patchify(pts, G, S), 20)
    parent_ms = cuda_ms(lambda: fps_ablation.parent_patchify(parent, pts, G, S), 5)
    split = device_split(lambda: patchify.fused_patchify(pts, G, S), PATCHIFY_SPLIT,
                         what=f"patchify ({B}, {N}), G {G}")
    p = fps.plan(B, N, *fps.card(pts.device))
    line = (f"{ms:.4f} ms a call (previous design {parent_ms:.4f}), device {split['total']:.4f}: "
            f"fps {split['fps']:.4f} (plan {tuple(p)}, {p.form}), knn rows "
            f"{split['knn rows']:.4f}; fps_idx and knn_idx bit for bit with the previous design")
    return fk, kk, ms, line


def phase_kernels(torch, pts, device, parents):
    """Each kernel against its plain version at the flagship shapes."""
    from point_dae_torch.losses import chamfer
    from point_dae_torch.ops import gather, mlp, patchify
    from point_dae_torch.ops.geometry import group_neighborhood

    records = {}
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    B, N, _ = pts.shape
    G, S = 64, 32

    # -- patchify: fps exact; knn only at genuine near-ties (tools/tpu_smoke.py);
    # both bit for bit with the previous design
    fps_k, knn_k, patchify_ms, line = patchify_report(torch, pts, G, S,
                                                      parents["patchify_parent"])
    log(f"  patchify ({B}, {N}), G {G}, S {S}: {line}")
    _, _, match, err = check_patchify(torch, pts, G, S, "patchify")
    nbytes = pts.numel() * 4 + fps_k.numel() * 4 + knn_k.numel() * 4
    records["patchify"] = dict(
        replaces="point_dae_tpu/ops/pallas_patchify.py:43",
        source="point_dae_torch/csrc/patchify.cu",
        max_abs_err=err,                                # selected kNN distances
        ms=patchify_ms,
        plain_ms=cuda_ms(lambda: patchify.fused_patchify_plain(pts, G, S), 3),
        library_ms=None, bound=bound_ms(nbytes, B * G * N * 8, F32_FLOPS),
        note=f"knn idx match {match:.6f}; {line}")

    # -- small-C gather: exact, int32 (the path's) and int64 indices
    idx = knn_k.reshape(B, G * S)
    got = gather.gather_rows_small_c(pts, idx)
    want = gather.gather_rows_small_c_plain(pts, idx)
    if not (torch.equal(got, want) and torch.equal(gather.gather_rows_small_c(pts, idx.long()), want)):
        fail("gather: kernel differs from the plain version")
    nbytes = pts.numel() * 4 + idx.numel() * 4 + got.numel() * 4
    t = gather_times(torch, pts, idx)
    log(f"  gather_rows_small_c ({B}, {N}, 3) by {G * S} rows: {gather_line(t)}")
    records["gather_rows_small_c"] = dict(
        replaces="point_dae_tpu/ops/pallas_scatter.py:116",
        source="point_dae_torch/csrc/gather.cu",
        max_abs_err=float((got - want).abs().max()), ms=t["ms"], plain_ms=t["plain_ms"],
        library_ms=None if t["lib_cast_dev"] is None else t["lib_cast_ms"],
        bound=bound_ms(nbytes, 0, F32_FLOPS),
        note=f"device {t['dev']:.4f} ms; library: torch.gather from the int32 index, cast "
             f"included (device {ms_text(t['lib_cast_dev'])}); from a ready int64 index "
             f"{t['lib_ready_ms']:.4f} (device {ms_text(t['lib_ready_dev'])})")

    # -- patch chamfer: 256*51 patches, 36 rebuilt points vs 32 true ones, both
    # directions in one launch, bit for bit with the plain halves and the
    # previous design
    neigh, _ = group_neighborhood(pts, G, S)
    y = neigh[:, :51].reshape(-1, S, 3).contiguous()               # (13056, 32, 3)
    x = (torch.randn((y.shape[0], 36, 3), generator=g, device=device) * 0.05).contiguous()
    ms, split, prev_ms, prev_dev = chamfer_report(torch, x, y, True, parents["chamfer_parent"],
                                                  "nn_half_small_pair")

    def lib_chamfer():
        d = torch.cdist(x, y) ** 2
        return d.min(2).values, d.min(1).values

    P, Nq, M = x.shape[0], 36, 32
    inputs = P * (Nq + M) * 3 * 4
    nbytes = inputs + P * (Nq + M) * (4 + 4 + 12)          # each input read once
    bound = bound_ms(nbytes, 2 * P * Nq * M * 8, F32_FLOPS)
    line = (f"{ms:.4f} ms a call, device {split['total']:.4f} (plan "
            f"{tuple(chamfer.patch_plan(Nq, M))}); previous design (a launch a direction) "
            f"{prev_ms:.4f} a call, device {ms_text(prev_dev)}; bound {bound[0]:.4f} by "
            f"{bound[1]} (each input read once; "
            f"{(nbytes + inputs) / HBM_BYTES_PER_S * 1e3:.4f} reading each twice); dist, idx "
            f"and near bit for bit with the plain halves and the previous design")
    log(f"  patch chamfer ({P}, {Nq} and {M}), both directions: {line}")
    records["nn_half_small"] = dict(
        replaces="point_dae_tpu/losses/chamfer.py:107",
        source="point_dae_torch/csrc/chamfer.cu", max_abs_err=0.0, ms=ms,
        plain_ms=cuda_ms(lambda: (chamfer.nn_half_small_plain(x, y),
                                  chamfer.nn_half_small_plain(y, x)), 5),
        library_ms=cuda_ms(lib_chamfer, 20), bound=bound,
        note=f"both directions, 36 vs 32 and 32 vs 36, one launch: {line}")

    # -- fused LN + MLP + residual: the decoder's rows, R = 256 * 64, then the
    # encoder's, R = 256 * 32 (the first rows of the same inputs)
    C, H = 384, 1536
    R = BATCH * 64
    xm = torch.randn((R, C), generator=g, device=device)
    gm = 1 + 0.1 * torch.randn((C,), generator=g, device=device)
    bt = 0.05 * torch.randn((C,), generator=g, device=device)
    k1 = torch.randn((C, H), generator=g, device=device) / math.sqrt(C)
    b1 = 0.02 * torch.randn((H,), generator=g, device=device)
    k2 = torch.randn((H, C), generator=g, device=device) / math.sqrt(H)
    b2 = 0.02 * torch.randn((C,), generator=g, device=device)
    keep = torch.rand((BATCH,), generator=g, device=device) >= 0.1
    sc = torch.where(keep, 1 / 0.9, 0.0).repeat_interleave(64).contiguous()
    cot = torch.randn((R, C), generator=g, device=device)
    bf = torch.bfloat16
    k1b, k2b = k1.to(bf).contiguous(), k2.to(bf).contiguous()
    for R in (BATCH * 64, BATCH * 32):
        x_r, sc_r, cot_r = (t[:R].contiguous() for t in (xm, sc, cot))
        leaves = [t.clone().requires_grad_() for t in (x_r, gm, bt, k1, b1, k2, b2)]
        y_k = mlp.fused_mlp_ln(*leaves, row_scale=sc_r)
        gk = torch.autograd.grad(y_k, leaves, cot_r)
        y_p = mlp.fused_mlp_ln_plain(x_r, gm, bt, k1, b1, k2, b2, sc_r)
        gp = mlp.mlp_ln_bwd_plain(x_r, gm, bt, k1b, b1, k2b, sc_r, cot_r, round_out=False)
        worst = {"y": rel_err(y_k - x_r, y_p - x_r)}
        abs_err = {"y": float((y_k - y_p).detach().abs().max())}
        for name, a, b in zip(MLP_LN_GRADS, gk, gp):
            worst[name] = rel_err(a, b)
            abs_err[name] = float((a.float() - b.float()).abs().max())
        log(f"  fused_mlp_ln at R {R} max error / max |plain| (gradients against "
            "mlp_ln_bwd_plain, weights before their bf16 rounding): "
            + " ".join(f"{k} {v:.2e}" for k, v in worst.items()))
        if worst["y"] > MLP_FWD_TOL:
            fail(f"fused_mlp_ln forward disagrees with its plain version at R {R}: {worst}")
        if max(v for k, v in worst.items() if k != "y") > MLP_BWD_TOL:
            fail(f"fused_mlp_ln backward disagrees with mlp_ln_bwd_plain at R {R}: {worst}")
        del leaves, y_k, gk, y_p, gp
        fwd_args = (x_r, gm, bt, k1b, b1, k2b, b2, sc_r)
        fwd = mlp_report(torch, "mlp_ln", "forward", lambda: mlp.mlp_ln_fwd_kernel(*fwd_args),
                         R, C, H, device,
                         plain=lambda: mlp.fused_mlp_ln_plain(x_r, gm, bt, k1, b1, k2, b2, sc_r))
        bwd_args = (x_r, gm, bt, k1b, b1, k2b, sc_r, cot_r)
        bwd = mlp_report(torch, "mlp_ln", "backward", lambda: mlp.mlp_ln_bwd_kernel(*bwd_args),
                         R, C, H, device, plain=lambda: mlp.mlp_ln_bwd_plain(*bwd_args))
        if R != BATCH * 64:
            continue
        io = R * C * 4
        wbytes = 2 * C * H * 2
        mm = 2 * R * C * H
        for name, rep, nbytes, flops, err in (
                ("mlp_ln_fwd", fwd, 2 * io + wbytes + R * 4, 2 * mm, abs_err["y"]),
                ("mlp_ln_bwd", bwd, 3 * io + 2 * wbytes + R * 4 + C * H * 4, 5 * mm,
                 max(v for k, v in abs_err.items() if k != "y"))):
            records[name] = dict(
                replaces="point_dae_tpu/ops/pallas_mlp.py:"
                         + ("227" if name.endswith("fwd") else "244"),
                source="point_dae_torch/csrc/mlp.cu", max_abs_err=err, ms=rep["ms"],
                plain_ms=rep["plain_ms"], library_ms=None,
                bound=bound_ms(nbytes, flops, BF16_FLOPS),
                note=f"R {R}, C {C}, H {H}; " + rep["note"])

    records.update(phase_folding(torch, device, g))
    records.update(phase_attention(torch, device, g))
    return records


def phase_folding(torch, device, g):
    """The fused folding head at the step's shape (256 * 51 tokens, C = F =
    384, 36 grid points) against its plain version on the card: the output
    and all thirteen gradients; the backward repeated bit for bit, both
    directions' device time by launch, the plain head beside the fused one,
    and the widths F 512 and 640."""
    from point_dae_torch.models.common import folding_grid
    from point_dae_torch.ops import folding

    Bt, M, C, n = BATCH, 51, 384, 36
    T, R = Bt * M, Bt * M * n
    grid = torch.from_numpy(folding_grid((6, 6))).to(device)

    def stage(extra):
        def w(i, o):
            return torch.randn((i, o), generator=g, device=device) / math.sqrt(i)
        return [w(C + extra, C), 0.02 * torch.randn((C,), generator=g, device=device),
                w(C, C), 0.02 * torch.randn((C,), generator=g, device=device),
                w(C, 3), 0.02 * torch.randn((3,), generator=g, device=device)]

    flat = [torch.randn((Bt, M, C), generator=g, device=device)] + stage(2) + stage(3)
    cot = torch.randn((Bt, M, n, 3), generator=g, device=device)
    names = ["dx"] + [f"d{k}{i}{s}" for s in (1, 2) for i in range(3) for k in "kb"]

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in flat]
        p1 = tuple((leaves[1 + 2 * i], leaves[2 + 2 * i]) for i in range(3))
        p2 = tuple((leaves[7 + 2 * i], leaves[8 + 2 * i]) for i in range(3))
        out = fn(leaves[0], grid, p1, p2)
        return (out, torch.autograd.grad(out, leaves, cot, retain_graph=True),
                (leaves[0], p1, p2))

    out_k, gk, _ = run(folding.fused_folding)
    out_p, gp, (xl, p1, p2) = run(folding.fused_folding_plain)
    torch.cuda.synchronize()
    worst = {"out": rel_err(out_k, out_p)}
    abs_err = {"out": float((out_k - out_p).detach().abs().max())}
    ok = relu_flips_ok(out_k, out_p)
    for name, a, b in zip(names, gk, gp):
        worst[name] = rel_err(a, b)
        abs_err[name] = float((a.float() - b.float()).abs().max())
        ok = ok and relu_flips_ok(a, b)
    log("  fused_folding max error / max |plain|: "
        + " ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    if not ok:
        fail(f"fused_folding disagrees with its plain version: {worst}")
    del gk, gp, out_k

    with torch.no_grad():
        core = folding.core_operands(xl, grid, p1, p2)
        ops = folding.kernel_operands(*core)
        gpad = cot.reshape(R, 3).contiguous()
        fwd_ms = cuda_ms(lambda: folding.folding_fwd_kernel(*ops), 10)
        bwd_ms = cuda_ms(lambda: folding.folding_bwd_kernel(*ops, gpad), 5)
        plain_fwd = cuda_ms(lambda: folding._FoldCorePlain.apply(*core), 3)
        # two backward calls agree bit for bit (no atomics, fixed-order sums)
        first = folding.folding_bwd_kernel(*ops, gpad)
        second = folding.folding_bwd_kernel(*ops, gpad)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            fail("folding_bwd: two calls on the same inputs differ")
        del first, second
        log("  folding_bwd: two calls agree bit for bit")
        split = device_split(lambda: folding.folding_bwd_kernel(*ops, gpad), FOLD_BWD_LAUNCHES,
                             what="folding_bwd")
        fsplit = device_split(lambda: folding.folding_fwd_kernel(*ops), FOLD_BWD_LAUNCHES,
                              what="folding_fwd")
    log("  folding_bwd device time by launch: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items() if v))
    log("  folding_fwd device time by launch: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in fsplit.items() if v))
    leaves = [xl] + [t for st in (p1, p2) for pair in st for t in pair]
    plain_bwd = cuda_ms(lambda: torch.autograd.grad(out_p, leaves, cot, retain_graph=True), 3)
    del out_p
    fold_head_yardstick(torch, device, xl, grid, p1, p2, cot, split, fsplit)
    F = C
    wide = 2 * 2 * R * F * F                     # a0 @ k11 and a2 @ k12
    shared = 2 * T * C * 2 * F                   # x @ [ks1 | ks2]
    narrow = 3 * 2 * R * F * 3                   # @ k21, @ ke2, @ k22
    flops = wide + shared + narrow
    wbytes = (2 * C * F + 2 * F * F + n * F + 13 * F) * 2
    records = {}
    for name, ms, pms, nbytes, fl, err in (
            ("folding_fwd", fwd_ms, plain_fwd, T * C * 2 + wbytes + R * 3 * 4, flops,
             abs_err["out"]),
            ("folding_bwd", bwd_ms, plain_bwd,
             2 * T * C * 2 + 2 * wbytes + R * 3 * 4, 3 * flops,
             max(v for k, v in abs_err.items() if k != "out"))):
        records[name] = dict(
            replaces="point_dae_tpu/ops/pallas_folding.py:"
                     + ("188" if name.endswith("fwd") else "225"),
            source="point_dae_torch/csrc/folding.cu", max_abs_err=err, ms=ms,
            plain_ms=pms, library_ms=None, bound=bound_ms(nbytes, fl, BF16_FLOPS),
            note=f"{T} tokens x {n} points, C = F = {C}")
    fold_widths(torch, device, g, grid)
    return records


# the folding kernels' launches by name (csrc/folding.cu), for the split of
# a call's device time
FOLD_BWD_LAUNCHES = (("rows pass", "fold_bwd_rows_kernel"),
                     ("weights pass", "fold_bwd_weights_kernel"),
                     ("forward tile", "fold_fwd_kernel"),
                     ("small products", "::gemm_kernel<"),
                     ("sums", "fold_sum_partials_kernel"))


def device_split(fn, names, calls: int = 5, what: str = ""):
    """Device milliseconds a call of fn by kernel name group
    (``kernel_events`` over `calls` calls); kernels matching no group (the
    wrapper's allocations) go to "other"."""
    out = {label: 0.0 for label, _ in names}
    out["other"] = 0.0
    for name, ms in kernel_events(fn, calls, what or "/".join(key for _, key in names)):
        label = next((lb for lb, key in names if key in name), "other")
        out[label] += ms
    out["total"] = sum(out.values())
    return out


def fold_head_yardstick(torch, device, xl, grid, p1, p2, cot, split, fsplit):
    """The plain folding head (fold_impl xla: the two SplitMLP stages in bf16
    on cuBLAS) at the same shape and weights, forward + backward device time,
    beside the fused head's (its wrapper included) in the same run."""
    from point_dae_torch.models.layers import SplitMLP
    from point_dae_torch.ops import folding

    bf = torch.bfloat16
    Bt, M, C = xl.shape
    n = grid.shape[0]
    s1 = SplitMLP(C, 2, (C, C, 3), dtype=bf).to(device)
    s2 = SplitMLP(C, 3, (C, C, 3), dtype=bf).to(device)
    with torch.no_grad():
        for mod, params in ((s1, p1), (s2, p2)):
            for i, (k, b) in zip((0, 2, 4), params):
                mod[i].weight.copy_(k.t())
                mod[i].bias.copy_(b)
    xb = xl.detach().to(bf).requires_grad_()
    gridb = grid.expand(Bt, M, n, 2).to(bf)
    plain_leaves = [xb, *s1.parameters(), *s2.parameters()]
    fused_leaves = [xl] + [t for st in (p1, p2) for pair in st for t in pair]

    def plain():
        out = s2(xb, s1(xb, gridb)).float()
        torch.autograd.grad(out, plain_leaves, cot)

    def fused():
        out = folding.fused_folding(xl, grid, p1, p2)
        torch.autograd.grad(out, fused_leaves, cot)

    plain_ms, _ = device_ms(plain, "the plain folding head", 5)
    fused_ms, _ = device_ms(fused, "the fused folding head", 5)
    log(f"  folding head yardstick, forward + backward device time a call at {Bt * M} tokens: "
        f"plain head (fold_impl xla, cuBLAS) {plain_ms:.4f} ms; fused head {fused_ms:.4f} ms "
        f"(kernels: fwd {fsplit['total'] - fsplit['other']:.4f}, bwd "
        f"{split['total'] - split['other']:.4f}; the rest casts, pads and allocations)")


FOLD_WIDE_F = ((512, 512), (256, 640))   # (C, F): the widest one-block F, a wide-form F


def fold_widths(torch, device, g, grid):
    """F 512 (one-block form) and F 640 (wide form) at 4 x 64 tokens against
    the plain version: output and all thirteen gradients."""
    from point_dae_torch.ops import folding

    n = grid.shape[0]
    for C, F in FOLD_WIDE_F:
        def w(i, o):
            return torch.randn((i, o), generator=g, device=device) / math.sqrt(i)

        def stage(extra):
            return [w(C + extra, F), 0.02 * torch.randn((F,), generator=g, device=device),
                    w(F, F), 0.02 * torch.randn((F,), generator=g, device=device),
                    w(F, 3), 0.02 * torch.randn((3,), generator=g, device=device)]

        flat = [torch.randn((4, 64, C), generator=g, device=device)] + stage(2) + stage(3)
        cot = torch.randn((4, 64, n, 3), generator=g, device=device)
        res = []
        for fn in (folding.fused_folding, folding.fused_folding_plain):
            leaves = [t.clone().requires_grad_() for t in flat]
            p1 = tuple((leaves[1 + 2 * i], leaves[2 + 2 * i]) for i in range(3))
            p2 = tuple((leaves[7 + 2 * i], leaves[8 + 2 * i]) for i in range(3))
            out = fn(leaves[0], grid, p1, p2)
            res.append((out, torch.autograd.grad(out, leaves, cot)))
        torch.cuda.synchronize()
        (ok, gk), (op, gp) = res
        worst = [rel_err(ok, op)] + [rel_err(a, b) for a, b in zip(gk, gp)]
        good = relu_flips_ok(ok, op) and all(relu_flips_ok(a, b) for a, b in zip(gk, gp))
        form = "one-block" if F <= 512 else "wide"
        log(f"  fused_folding at C {C}, F {F} ({form} form), 256 tokens: max error / max |plain| "
            f"{max(worst):.2e} over the output and 13 gradients")
        if not good:
            fail(f"fused_folding at C {C}, F {F} disagrees with its plain version: {worst}")


def phase_attention(torch, device, g, heads: int = 6):
    """The fused attention at the step's two shapes (B 256, H 6, d 64; T 32
    with 13 to 32 valid keys a cloud, T 64 without a mask) against its plain
    version on the card: output, dq, dk, dv, and exact zeros on the
    gradients of invalid keys. library_ms is one call of
    F.scaled_dot_product_attention on the same bf16 inputs (timing only).
    ``heads`` 3: the same at a tensor-parallel rank's share of the heads
    (records ``attention_fwd_h3``, ``attention_bwd_h3``; no gate shapes)."""
    import torch.nn.functional as F
    from point_dae_torch.ops import attention

    Bt, H, d = BATCH, heads, 64
    tag = "" if heads == 6 else f" H {heads}"
    bf = torch.bfloat16
    errs, shapes = {"fwd": 0.0, "bwd": 0.0}, {}
    for T, masked in ((32, True), (64, False)):
        qkv = torch.randn((Bt, T, 3, H, d), generator=g, device=device)
        cot = torch.randn((Bt, T, H, d), generator=g, device=device)
        mask = None
        if masked:
            valid = torch.randint(13, T + 1, (Bt,), generator=g, device=device)
            mask = torch.arange(T, device=device)[None, :] < valid[:, None]

        def run(fn):
            leaf = qkv.clone().requires_grad_()
            q, k, v = leaf.to(bf).unbind(2)
            out = fn(q, k, v, mask)
            return (out, torch.autograd.grad(out, leaf, cot, retain_graph=True)[0],
                    leaf, (q, k, v))

        out_k, gk, _, _ = run(attention.fused_attention)
        out_p, gp, leaf_p, (q, k, v) = run(attention.fused_attention_plain)
        torch.cuda.synchronize()
        worst = {"out": rel_err(out_k, out_p)}
        for i, name in enumerate(("dq", "dk", "dv")):
            worst[name] = rel_err(gk[:, :, i], gp[:, :, i])
        log(f"  fused_attention{tag} T {T} max error / max |plain|: "
            + " ".join(f"{k_} {v_:.2e}" for k_, v_ in worst.items()))
        if max(worst.values()) > 2e-2:  # bf16 operands: 2^-8 per rounding, summed
            fail(f"fused_attention{tag} (T {T}) disagrees with its plain version: {worst}")
        if masked and float(gk[:, :, 1:][~mask].abs().max()) != 0.0:
            fail("fused_attention: an invalid key got a gradient")
        errs["fwd"] = max(errs["fwd"], float((out_k - out_p).detach().abs().max()))
        errs["bwd"] = max(errs["bwd"], float((gk - gp).abs().max()))

        q, k, v = (t.detach() for t in (q, k, v))
        lq, lk, lv = (t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v))
        amask = None if mask is None else mask[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=amask)
        lib_cot = cot.transpose(1, 2).to(bf)
        nel = Bt * T * H * d
        shapes[T] = dict(
            fwd=cuda_ms(lambda: attention.attention_fwd_kernel(q, k, v, mask), 50),
            bwd=cuda_ms(lambda: attention.attention_bwd_kernel(q, k, v, mask, cot), 50),
            plain_fwd=cuda_ms(lambda: attention.fused_attention_plain(q, k, v, mask), 10),
            plain_bwd=cuda_ms(lambda: torch.autograd.grad(
                out_p, leaf_p, cot, retain_graph=True), 10),
            lib_fwd=cuda_ms(lambda: F.scaled_dot_product_attention(
                lq.detach(), lk.detach(), lv.detach(), attn_mask=amask), 50),
            lib_bwd=cuda_ms(lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), lib_cot, retain_graph=True), 50),
            dev_fwd=device_ms(lambda: attention.attention_fwd_kernel(q, k, v, mask),
                              f"attention_fwd_kernel T {T}")[0],
            dev_bwd=device_ms(lambda: attention.attention_bwd_kernel(q, k, v, mask, cot),
                              f"attention_bwd_kernel T {T}")[0],
            lib_dev_fwd=device_ms(lambda: F.scaled_dot_product_attention(
                lq.detach(), lk.detach(), lv.detach(), attn_mask=amask), f"SDPA T {T}",
                library=True)[0],
            lib_dev_bwd=device_ms(lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), lib_cot, retain_graph=True),
                f"SDPA's autograd backward T {T}", library=True)[0],
            bound_fwd=bound_ms(3 * nel * 2 + Bt * T + nel * 4,
                               2 * 2 * Bt * H * T * T * d, BF16_FLOPS),
            bound_bwd=bound_ms(3 * nel * 2 + Bt * T + nel * 4 + 3 * nel * 2,
                               5 * 2 * Bt * H * T * T * d, BF16_FLOPS))
    s64 = shapes[64]
    log(f"  fused_attention{tag} at T 64: fwd {s64['fwd']:.4f} ms (plain {s64['plain_fwd']:.4f}, "
        f"library {s64['lib_fwd']:.4f}, bound {s64['bound_fwd'][0]:.4f}), bwd "
        f"{s64['bwd']:.4f} ms (plain {s64['plain_bwd']:.4f}, library {s64['lib_bwd']:.4f}, "
        f"bound {s64['bound_bwd'][0]:.4f})")
    for T, sh in shapes.items():
        log(f"  fused_attention{tag} T {T} device time (torch.profiler): fwd {sh['dev_fwd']:.4f} ms "
            f"(SDPA {ms_text(sh['lib_dev_fwd'])}), bwd {sh['dev_bwd']:.4f} ms (SDPA's autograd "
            f"backward {ms_text(sh['lib_dev_bwd'])})")
    if heads == 6:
        attention_gate_shapes(torch, device, g)
    s32 = shapes[32]
    records = {}
    for way, line in (("fwd", "144"), ("bwd", "168")):
        records[f"attention_{way}" + ("" if heads == 6 else f"_h{heads}")] = dict(
            replaces=f"point_dae_tpu/ops/pallas_attn.py:{line}",
            source="point_dae_torch/csrc/attention.cu", max_abs_err=errs[way],
            ms=s32[way], plain_ms=s32[f"plain_{way}"],
            library_ms=None if s32[f"lib_dev_{way}"] is None else s32[f"lib_{way}"],
            bound=s32[f"bound_{way}"],
            note=f"B 256, H {H}, d 64, T 32 with a key mask (12 of a step's 16 launches); "
                 f"device {s32[f'dev_{way}']:.4f} ms, SDPA's {ms_text(s32[f'lib_dev_{way}'])}")
    return records


# Shapes inside the gate the models do not reach: (B, T, H, d, masked) with
# the JAX tile bc = pick_bc(B, T) of each: 8, 4 and 2
ATTN_GATE_SHAPES = ((16, 40, 6, 32, True), (8, 128, 6, 64, False), (2, 256, 6, 128, False))


def attention_gate_shapes(torch, device, g):
    """The fused attention at the off-path gate shapes against its plain
    version on the card, forward and backward within the path shapes'
    2e-2, exact zeros on invalid keys; each launch's time and dynamic
    shared memory."""
    from point_dae_torch.ops import attention

    bf = torch.bfloat16
    for Bt, T, H, d, masked in ATTN_GATE_SHAPES:
        if not attention.supported(Bt, T, H, d):
            fail(f"fused_attention: ({Bt}, {T}, {H}, {d}) is not inside the gate")
        qkv = torch.randn((Bt, T, 3, H, d), generator=g, device=device)
        cot = torch.randn((Bt, T, H, d), generator=g, device=device)
        mask = None
        if masked:
            mask = torch.rand((Bt, T), generator=g, device=device) < 0.6
            mask[:, 0] = True

        def run(fn):
            leaf = qkv.clone().requires_grad_()
            q, k, v = leaf.to(bf).unbind(2)
            out = fn(q, k, v, mask)
            return out, torch.autograd.grad(out, leaf, cot)[0], (q, k, v)

        out_k, gk, _ = run(attention.fused_attention)
        out_p, gp, (q, k, v) = run(attention.fused_attention_plain)
        torch.cuda.synchronize()
        worst = {"out": rel_err(out_k, out_p)}
        for i, name in enumerate(("dq", "dk", "dv")):
            worst[name] = rel_err(gk[:, :, i], gp[:, :, i])
        if max(worst.values()) > 2e-2:  # bf16 operands: 2^-8 per rounding, summed
            fail(f"fused_attention ({Bt}, {T}, {H}, {d}) disagrees with its plain version: "
                 f"{worst}")
        if masked and float(gk[:, :, 1:][~mask].abs().max()) != 0.0:
            fail(f"fused_attention ({Bt}, {T}, {H}, {d}): an invalid key got a gradient")
        q, k, v = (t.detach() for t in (q, k, v))
        fwd = cuda_ms(lambda: attention.attention_fwd_kernel(q, k, v, mask), 20)
        bwd = cuda_ms(lambda: attention.attention_bwd_kernel(q, k, v, mask, cot), 20)
        smem = attention.smem_bytes(T, d)
        log(f"  fused_attention B {Bt}, T {T}, H {H}, d {d}{' masked' if masked else ''} (bc "
            f"{attention.pick_bc(Bt, T)}): max error / max |plain| "
            + " ".join(f"{k_} {v_:.2e}" for k_, v_ in worst.items())
            + f"; fwd {fwd:.4f} ms, bwd {bwd:.4f} ms; shared memory fwd {smem[0]} B, bwd "
              f"{smem[1]} B")


def log_attention_build(text: str) -> None:
    """The attention kernels' registers, spills and barriers (nvcc -Xptxas -v),
    one line a kernel and head width, and each path shape's shared memory."""
    import re

    from point_dae_torch.ops import attention

    name = None
    for line in text.splitlines():
        m = re.search(r"\d(attention_[a-z_]+?_kernel)I((?:Li\d+E)+)", line)
        if "Compiling entry function" in line and m:
            args = ", ".join(re.findall(r"Li(\d+)E", m.group(2)))
            name = f"{m.group(1)}<{args}>"
        elif name and ("Used" in line or "spill" in line):
            log(f"  attention: {name}: {line.split(':', 1)[-1].strip()}")
    for T in (32, 64):
        fwd, bwd = attention.smem_bytes(T, 64)
        log(f"  attention: T {T}, d 64: dynamic shared memory fwd {fwd} B, bwd {bwd} B a block")


def log_named_build(src: str, text: str, pattern: str) -> None:
    """Registers, spills and barriers (nvcc -Xptxas -v) of the kernels of one
    source whose mangled names match pattern, one line a kernel."""
    import re

    name = None
    for line in text.splitlines():
        m = re.search(pattern, line)
        if "Compiling entry function" in line:
            name = m.group(1) if m else None
        elif name and ("Used" in line or "spill" in line):
            log(f"  {src}: {name}: {line.split(':', 1)[-1].strip()}")


def edgeconv_work(B, N, Cf, C, k):
    """(bytes, f32 operations) of knn_aggregate's forward and of one of its
    backwards at one shape: the forward reads x (Cf) and U (C) and writes
    M, m, S1, S2, rM, rm and idx, over N (2 Cf + 3) operations of distance,
    k N of selection and 7 k C of aggregation a row; a backward reads U,
    the two saved tensors, four cotangents and idx and writes dU, over 6 k C
    operations a row."""
    fwd = (B * N * (Cf + 7 * C + k) * 4, B * N * (N * (2 * Cf + 3) + k * N + k * C * 7))
    bwd = (8 * B * N * C * 4 + B * N * k * 4, B * N * k * C * 6)
    return fwd, bwd


# csrc/edgeconv.cu's launches by kernel name: the forward's selection and
# aggregate, the backward's tie-weight pass ('split'), counting sort and sums
EDGECONV_SPLIT = (("select", "knn_select_kernel"), ("sqnorm", "row_sqnorm_kernel"),
                  ("aggregate", "edgeconv_aggregate"), ("ties", "tie_weights_kernel"),
                  ("sort", "contrib_"), ("sum", "edgeconv_bwd_kernel"))


def split_line(split) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in split.items() if v and k != "total")


def aggregate_report(torch, U, idx, parent, what):
    """The aggregate alone (aggregate_from_idx's launch, the staged form under
    ops/edgeconv.py:aggregate_plan) at one shape against the previous design
    (``parent``, built from point_dae_torch/tools/aggregate_parent.cu): every
    output bit for bit with track on and off; the device ms a call of each
    with track on (torch.profiler; the previous design's a yardstick, null
    where its windows are lost) and the bound by bytes (U, idx, the four f32
    outputs and the two round bytes). Returns (ms, previous ms, bound, plan)."""
    from point_dae_torch.ops import edgeconv
    from point_dae_torch.tools import rowreduce_ablation

    B, N, C = U.shape
    k = idx.shape[-1]
    for track in (True, False):
        got = edgeconv.aggregate_fwd_kernel(U, idx, track)
        prev = rowreduce_ablation.parent_aggregate(parent, U, idx, track)
        torch.cuda.synchronize()
        if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, prev)):
            fail(f"aggregate {what}: differs from the previous design in its bits "
                 f"(track {track})")
    ms, _ = device_ms(lambda: edgeconv.aggregate_fwd_kernel(U, idx, True), f"aggregate {what}",
                      10)
    prev_ms, _ = device_ms(lambda: rowreduce_ablation.parent_aggregate(parent, U, idx, True),
                           f"previous aggregate {what}", 10, library=True)
    bound = bound_ms(B * N * (22 * C + 4 * k), 0, F32_FLOPS)
    return ms, prev_ms, bound, edgeconv.aggregate_plan(B, N, C)


def phase_dgcnn_kernels(torch, corrupted, clean, device, parent, parents):
    """The DGCNN step's kernels at its shapes (batch 128, 1024 points, k 20)
    against their plain versions on the card; the EdgeConv kernels' device
    time by launch, torch.topk over torch.cdist beside the forward, and the
    backwards and the selection held bit for bit against the previous
    design (``parent``, the library built from
    point_dae_torch/tools/edgeconv_parent.cu); the aggregate alone against
    its previous design (``parents["aggregate_parent"]``, aggregate_report);
    the tiled chamfer against its plain halves and previous design
    (``parents["chamfer_parent"]``, chamfer_report)."""
    from point_dae_torch.tools import edgeconv_ablation
    from point_dae_torch.losses import chamfer
    from point_dae_torch.ops import edgeconv
    from point_dae_torch.utils import kernels

    records = {}
    g = torch.Generator(device=device).manual_seed(SEED + 5)
    B, N, k = DGCNN_BATCH, 1024, 20

    # -- tiled chamfer: a reconstruction against the clean cloud, both ways in
    # one launch, bit for bit with the plain halves and the previous design
    x = (clean + 0.05 * torch.randn(clean.shape, generator=g, device=device)).contiguous()
    x[:, 7] = clean[:, 9]                      # exact hits: distance 0
    y = clean.contiguous()
    ms, split, prev_ms, prev_dev = chamfer_report(torch, x, y, False,
                                                  parents["chamfer_parent"],
                                                  "nn_half_tiled_pair")

    def lib_chamfer():
        d = torch.cdist(x, y) ** 2
        return d.min(2).values, d.min(1).values

    pairs = 2 * B * N * N
    floor = [pairs * 8 / (kernels.card_sms(device) * 128 * hz) * 1e3 for hz in CLOCKS_HZ]
    bound = bound_ms(2 * (2 * B * N * 3 * 4 + B * N * 8), pairs * 9, F32_FLOPS)
    line = (f"{ms:.4f} ms a call, device {split['total']:.4f} (plan "
            f"{tuple(chamfer.tiled_plan(B, N, N, kernels.card_sms(device)))}); previous design "
            f"(a launch a direction) {prev_ms:.4f} a call, device {ms_text(prev_dev)}; bound "
            f"{bound[0]:.4f} by {bound[1]}; rounding-rule floor (eight instructions a pair) "
            f"{floor[0]:.4f}-{floor[1]:.4f} at {CLOCKS_HZ[0] / 1e9:.3f}-{CLOCKS_HZ[1] / 1e9:.3f} "
            f"GHz; dist and idx bit for bit with the plain halves and the previous design")
    log(f"  tiled chamfer ({B}, {N}, {N}), both directions: {line}")
    records["nn_half_tiled"] = dict(
        replaces="point_dae_tpu/losses/chamfer.py:41",
        source="point_dae_torch/csrc/chamfer.cu", max_abs_err=0.0, ms=ms,
        plain_ms=cuda_ms(lambda: (chamfer.nn_half_tiled_plain(x, y),
                                  chamfer.nn_half_tiled_plain(y, x)), 3),
        library_ms=cuda_ms(lib_chamfer, 10), bound=bound,
        note=f"both directions, 1024 vs 1024, one launch: {line}")
    del x, y

    # -- fused kNN aggregate at the four EdgeConv shapes. Layer 1 sees the
    # corrupted cloud itself (resampled with replacement: duplicated points);
    # deeper layers see features, duplicated where the points are. U holds
    # bf16 values, as the bf16 edge projection leaves them.
    names = ("knn_aggregate_fwd", "knn_aggregate_bwd_first", "knn_aggregate_bwd_split")
    tot = {n: dict(ms=0.0, plain_ms=0.0, nbytes=0.0, flops=0.0, err=0.0, dev=0.0)
           for n in names}
    lib_ms = select_dev = macs = 0.0
    agg = dict(ms=0.0, prev_ms=0.0, bound=0.0)
    parts = {"first": {}, "split": {}}
    dup = corrupted[:, :, None, :].eq(corrupted[:, None, :64, :]).all(-1)   # (B, N, 64)
    first_twin = torch.where(dup.any(-1), dup.float().argmax(-1),
                             torch.arange(N, device=device)[None, :].expand(B, -1))
    del dup
    for Cf, C in ((3, 64), (64, 64), (64, 128), (128, 256)):
        if Cf == 3:
            xf = corrupted.contiguous()
        else:
            xf = torch.randn((B, N, Cf), generator=g, device=device)
            xf = torch.gather(xf, 1, first_twin[..., None].expand(-1, -1, Cf)).contiguous()
        U = torch.randn((B, N, C), generator=g, device=device).bfloat16().float()
        U = torch.gather(U, 1, first_twin[..., None].expand(-1, -1, C)).contiguous()
        cots = [torch.randn((B, N, C), generator=g, device=device) for _ in range(4)]
        outk = edgeconv.knn_aggregate_fwd_kernel(U, xf, k, True)
        idx = edgeconv.knn_select_plain(xf, k)
        outp = edgeconv.aggregate_plain(U, idx)
        torch.cuda.synchronize()
        if not torch.equal(outk[4], idx):
            fail(f"knn_aggregate Cf {Cf}: neighbours differ from the plain version "
                 f"(match {float((outk[4] == idx).float().mean())})")
        if not torch.equal(edgeconv_ablation.parent_select(parent, xf, k)[1], idx):
            fail(f"knn_aggregate Cf {Cf}: neighbours differ from the previous design's")
        for nm, a, b in zip(("M", "m", "S1", "S2", "rM", "rm"), outk[:4] + outk[5:], outp):
            if not torch.equal(a.to(b.dtype), b):
                fail(f"knn_aggregate Cf {Cf}: {nm} differs from the plain version")
        M, m, _, _, _, rM, rm = outk
        ties = float((torch.gather(U, 1, idx[:, :, 1, None].long().expand(-1, -1, C))
                      == torch.gather(U, 1, idx[:, :, 0, None].long().expand(-1, -1, C))
                      ).all(-1).float().mean())
        shape_ms = {}
        for mode, a, c, plain in (("first", rM, rm, edgeconv.bwd_first_plain),
                                  ("split", M, m, edgeconv.bwd_split_plain)):
            run = lambda: edgeconv.knn_aggregate_bwd_kernel(mode, U, idx, a, c, *cots)
            du, du2 = run(), run()
            want = plain(U, idx, a, c, *cots)
            torch.cuda.synchronize()
            err = rel_err(du, want)
            if err > 1e-5:      # f32 sums of a row's contributions, in another order
                fail(f"knn_aggregate bwd {mode} Cf {Cf}: du off by {err:.2e} of max |du|")
            if not torch.equal(du, du2):
                fail(f"knn_aggregate bwd {mode}: two runs differ in their bits")
            if not torch.equal(du, edgeconv_ablation.parent_bwd(parent, mode, U, idx, a, c,
                                                                *cots)):
                fail(f"knn_aggregate bwd {mode} Cf {Cf}: du differs from the previous "
                     f"design's in its bits")
            t = tot[f"knn_aggregate_bwd_{mode}"]
            t["err"] = max(t["err"], float((du - want).abs().max()))
            shape_ms[mode] = cuda_ms(run, 5)
            split = device_split(run, EDGECONV_SPLIT, what=f"knn_aggregate bwd {mode} Cf {Cf}")
            t["dev"] += split["total"]
            for key, v in split.items():
                parts[mode][key] = parts[mode].get(key, 0.0) + v
            shape_ms[mode + " split"] = split_line(split)
            t["ms"] += shape_ms[mode]
            t["plain_ms"] += cuda_ms(lambda: plain(U, idx, a, c, *cots), 1)
            t["nbytes"] += edgeconv_work(B, N, Cf, C, k)[1][0]
            t["flops"] += edgeconv_work(B, N, Cf, C, k)[1][1]
            del du, du2, want
        t = tot["knn_aggregate_fwd"]
        fwd = lambda: edgeconv.knn_aggregate_fwd_kernel(U, xf, k, True)  # noqa: E731
        shape_ms["fwd"] = cuda_ms(fwd, 5)
        t["ms"] += shape_ms["fwd"]
        split = device_split(fwd, EDGECONV_SPLIT, what=f"knn_aggregate fwd Cf {Cf}")
        t["dev"] += split["total"]
        select_dev += split["select"] + split["sqnorm"]
        shape_ms["fwd split"] = split_line(split)
        shape_ms["lib"] = cuda_ms(lambda: torch.topk(torch.cdist(xf, xf), k, dim=-1,
                                                     largest=False), 5)
        lib_ms += shape_ms["lib"]
        macs += B * N * N * Cf
        t["plain_ms"] += cuda_ms(lambda: edgeconv.aggregate_plain(
            U, edgeconv.knn_select_plain(xf, k)), 1)
        t["nbytes"] += edgeconv_work(B, N, Cf, C, k)[0][0]
        t["flops"] += edgeconv_work(B, N, Cf, C, k)[0][1]
        a_ms, a_prev, a_bound, a_plan = aggregate_report(
            torch, U, idx, parents["aggregate_parent"], f"Cf {Cf} C {C}")
        agg["ms"] += a_ms
        agg["prev_ms"] += a_prev if a_prev is not None else math.nan
        agg["bound"] += a_bound[0]
        log(f"  aggregate Cf {Cf:3d} C {C:3d} (plan {tuple(a_plan)}): device {a_ms:.4f} ms, "
            f"previous design {ms_text(a_prev)}, bound {a_bound[0]:.4f} by bytes; bit for bit "
            f"with the previous design, track on and off")
        log(f"  knn_aggregate Cf {Cf:3d} C {C:3d}: fwd {shape_ms['fwd']:.4f} ms (device "
            f"{shape_ms['fwd split']}; torch.topk over torch.cdist {shape_ms['lib']:.4f}), bwd "
            f"first {shape_ms['first']:.4f} ms (device {shape_ms['first split']}), bwd split "
            f"{shape_ms['split']:.4f} ms (device {shape_ms['split split']}); forward bit for "
            f"bit, rows whose 2 nearest tie in U {ties:.4f}; idx and both du bit for bit with "
            f"the previous design")
        del outk, outp, cots
        torch.cuda.empty_cache()
    # the distances' multiply-adds as the rounding rule keeps them: a rounded
    # product and a rounded sum, two instructions at half the FMA rate's flops
    floor = 2 * macs / (F32_FLOPS / 2) * 1e3
    notes = {
        "knn_aggregate_fwd": f"device {tot['knn_aggregate_fwd']['dev']:.4f} ms, of which the "
                             f"selection {select_dev:.4f}; rounding-rule floor of the distances "
                             f"{floor:.4f} ms (no FMA); the aggregate alone {agg['ms']:.4f} ms "
                             f"(previous design {agg['prev_ms']:.4f}, bound {agg['bound']:.4f} by "
                             f"bytes); library: torch.topk over torch.cdist",
        "knn_aggregate_bwd_first": f"device {tot['knn_aggregate_bwd_first']['dev']:.4f} ms: "
                                   + split_line(parts["first"]),
        "knn_aggregate_bwd_split": f"device {tot['knn_aggregate_bwd_split']['dev']:.4f} ms: "
                                   + split_line(parts["split"])}
    for n, line in zip(names, ("98", "457", "340")):
        t = tot[n]
        records[n] = dict(
            replaces=f"point_dae_tpu/ops/pallas_edgeconv.py:{line}",
            source="point_dae_torch/csrc/edgeconv.cu", max_abs_err=t["err"], ms=t["ms"],
            plain_ms=t["plain_ms"], library_ms=lib_ms if n == "knn_aggregate_fwd" else None,
            bound=bound_ms(t["nbytes"], t["flops"], F32_FLOPS),
            note="sum over the four EdgeConv shapes of a step (B 128, N 1024, k 20); "
                 + notes[n])
    return records


def phase_dgcnn_check(torch, config, corrupted, clean, device):
    """The full-width DGCNN encoder on the card (impl auto: the fused kernel)
    at DGCNN_CHECK_BATCH against the same weights on the CPU, three ways:

    - in f32, each of the four layers on the card against the reference
      EdgeConv (edge tensor + Dense, the independent layout) and against
      the kernel's plain version, both on the CPU on the same input (the
      plain chain's activations), within 1e-3 (relative and absolute). The
      reference's kNN (matmul distances) and the kernel's (exact
      distances) can order a near-tie apart: on each layer's input the rows
      whose two selections part as sets are found (``knn_flips``), every
      other row is held to the reference, and those rows must be at most
      1e-3 of a layer's and each such pick within rounding of the other
      side's (spread at most 2 (C + 2) units, as fine-tune C's check holds
      them). The whole encoder (impl auto on the card, the reference on the
      CPU) is held to a mean gap of 1e-3 and a largest of 5% of the largest
      feature: four chained kNN graphs carry a near-tie's flip to the
      global feature (a run on an H100 read 4.3e-2 against the reference
      and 3.7e-2 against the plain chain, with the two selections parting
      on 3 picks of the four layers), where sound runs read 3e-5 without
      one;
    - in bf16, the step's type, each of the four fused layers on the card
      against the reference EdgeConv on the CPU on the same input (the CPU
      reference chain's activations), within the 0.05 (relative and
      absolute) that the JAX package's test of one fused layer against one
      reference layer under bf16 allows, for all but one element in 10,000
      (the two kNNs sum a distance in another order, so on the pipeline's
      clouds, which repeat points, a twentieth neighbour at a near tie can
      differ: sound runs read at most 2 elements of a layer's 0.5-2 million
      outside and a largest gap of 0.06-0.08 on the card, up to 0.36 with
      the plain version on the CPU), with a mean gap of at most 0.01
      (sound: 0.002-0.003). A planted fault (the farthest neighbour dropped, the sum
      of squares a twentieth off) puts 2-8% of a layer's elements outside
      and reads a mean gap of 0.025-0.036;
    - in bf16, the whole encoder against the CPU's ``fused`` impl (the same
      split projection with gathered aggregates), and the loss against the
      CPU's plain chamfer within 2%. The card's and the CPU's products round
      apart, a neighbour near a distance tie can flip, and four chained kNN
      graphs amplify it, so this is held by two readings: sound runs read a
      largest gap of 0.46 where the largest feature is 17.26 (2.7%) and a
      mean gap of 0.005, while a planted fault in the aggregate (the farthest
      neighbour dropped or replaced, the point itself left out, the sum of
      squares off by a twentieth) reads a largest gap of 19-64% of the
      largest feature and a mean gap of 0.22-1.07. The limits are 5% of the
      largest feature and a mean of 0.05. Chained through four layers the
      bf16 reference layout itself sits 1.5-3 away from the fused one (mean
      0.10-0.13), in this package and in the JAX one alike
      (tests/test_torch_edgeconv.py), so it is printed, not held to."""
    from point_dae_torch.engine.pretrain import init_model
    from point_dae_torch.models.dgcnn import edge_conv, fused_edge_conv
    from point_dae_torch.utils import kernels

    cor, cln = corrupted[:DGCNN_CHECK_BATCH], clean[:DGCNN_CHECK_BATCH]
    cor_cpu, cln_cpu = cor.cpu(), cln.cpu()
    f32 = copy.deepcopy(config)
    del f32["model"]["dtype"]
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    gap = lambda a, b: float((a - b).abs().max())
    with torch.no_grad():
        cpu_model = init_model(f32, seed=SEED + 6, device="cpu").train()
        gpu_model = copy.deepcopy(cpu_model).to(device).train()
        err32 = (gpu_model.dgcnn_encoder(cor)[0].cpu(), cpu_model.dgcnn_encoder(cor_cpu)[0])
        inputs32 = []
        plain32 = dgcnn_feature_plain(torch, cpu_model.dgcnn_encoder, cor_cpu[..., :3],
                                      inputs32)
        enc_c, enc_g = cpu_model.dgcnn_encoder, gpu_model.dgcnn_encoder
        flips32, layers32 = [], []
        for i, xin in enumerate(inputs32, 1):
            by_pos, by_set, spread, apart = knn_flips(torch, xin, enc_c.k)
            flips32.append((xin.shape[-1], by_pos, by_set, spread, int(apart.sum())))
            conv, bn = getattr(enc_c, f"conv{i}")[0], getattr(enc_c, f"bn{i}")
            want = fused_edge_conv(xin, conv, bn, enc_c.k, enc_c.dtype, interpret=True,
                                   **enc_c.fused_flags)
            ref = edge_conv(xin, conv, bn, enc_c.k, enc_c.dtype)
            got = fused_edge_conv(xin.to(device), getattr(enc_g, f"conv{i}")[0],
                                  getattr(enc_g, f"bn{i}"), enc_g.k, enc_g.dtype,
                                  **enc_g.fused_flags).cpu()
            keep = ~apart
            layers32.append((gap(got, want), torch.allclose(got, want, rtol=1e-3, atol=1e-3),
                             gap(got[keep], ref[keep]),
                             torch.allclose(got[keep], ref[keep], rtol=1e-3, atol=1e-3)))

        cpu_model = init_model(config, seed=SEED + 6, device="cpu").train()
        gpu_model = copy.deepcopy(cpu_model).to(device).train()
        enc_c, enc_g = cpu_model.dgcnn_encoder, gpu_model.dgcnn_encoder
        layers, h = [], cor_cpu[..., :3]
        for i in range(1, len(enc_c.WIDTHS) + 1):
            want = edge_conv(h, getattr(enc_c, f"conv{i}")[0], getattr(enc_c, f"bn{i}"),
                             enc_c.k, enc_c.dtype)
            got = fused_edge_conv(h.to(device), getattr(enc_g, f"conv{i}")[0],
                                  getattr(enc_g, f"bn{i}"), enc_g.k, enc_g.dtype).cpu()
            outside = ~torch.isclose(got, want, rtol=0.05, atol=0.05)
            layers.append((gap(got, want), float((got - want).abs().mean()),
                           int(outside.sum()), outside.numel()))
            h = want
        ref16 = enc_c(cor_cpu)[0]
        enc_c.impl = "fused"
        fg = enc_g(cor)[0].cpu()
        lg = float(gpu_model(cor, cln)[0])
        fc = enc_c(cor_cpu)[0]
        lc = float(cpu_model(cor_cpu, cln_cpu)[0])
    used = {k: kernels.launches[k] - before[k] for k in DGCNN_COUNTERS[:2]}
    top, mean_gap = float(fc.abs().max()), float((fg - fc).abs().mean())
    top32, mean32 = float(err32[1].abs().max()), float((err32[0] - err32[1]).abs().mean())
    log(f"  DGCNN batch {DGCNN_CHECK_BATCH} (cpu {time.perf_counter() - t0:.1f} s): global "
        f"feature max |card - cpu|: f32 kernel vs reference EdgeConv {gap(*err32):.2e} "
        f"(mean {mean32:.2e}, max |feature| {top32:.2f}), vs the kernel's plain chain "
        f"{gap(err32[0], plain32):.2e}; f32 kernel layer on one input vs its plain version "
        f"{[round(l_[0], 7) for l_ in layers32]}, vs the reference EdgeConv on the rows "
        f"whose kNN picks agree {[round(l_[2], 7) for l_ in layers32]}; the reference's "
        f"and the plain kNN on each layer's input (C, idx differing, picks differing as "
        f"sets, spread in units, rows apart) "
        f"{[(c, p_, s_, round(sp, 1), r_) for c, p_, s_, sp, r_ in flips32]}; bf16 "
        f"kernel layer vs reference EdgeConv layer on one input "
        f"(max, mean, elements outside 0.05) "
        f"{[(round(g_, 4), round(m_, 5), o_) for g_, m_, o_, _ in layers]}; "
        f"bf16 kernel vs cpu fused {gap(fg, fc):.4f}, "
        f"mean {mean_gap:.4f} (max |feature| {top:.2f}); bf16 cpu fused vs cpu reference "
        f"{gap(fc, ref16):.4f}, mean {float((fc - ref16).abs().mean()):.4f}")
    log(f"  DGCNN batch {DGCNN_CHECK_BATCH}: loss on the card (kernels) {lg:.6f}, on the cpu "
        f"(fused, plain chamfer) {lc:.6f}; launches {used}")
    if not (math.isfinite(lg) and math.isfinite(lc)):
        fail("check: non-finite DGCNN loss")
    if not all(ok and ok_ref for _, ok, _, ok_ref in layers32):
        fail(f"check: an f32 EdgeConv layer on the card is off its plain version or the "
             f"reference EdgeConv on the same input beyond 1e-3: {layers32}")
    rows = inputs32[0].shape[0] * inputs32[0].shape[1]
    if not all(sp <= 2 * (c + 2) and r_ <= 1e-3 * rows for c, _, _, sp, r_ in flips32):
        fail(f"check: the reference's and the kernel's kNN part off a near-tie or on too "
             f"many rows: {flips32}")
    if mean32 > 1e-3 or gap(*err32) > 0.05 * top32:
        fail(f"check: f32 DGCNN features on the card off the reference EdgeConv's by "
             f"{gap(*err32)} (mean {mean32})")
    if not all(o_ <= 1e-4 * n_ and m_ <= 0.01 for _, m_, o_, n_ in layers):
        fail(f"check: a bf16 fused EdgeConv layer on the card is off the reference layer "
             f"beyond 0.05: {layers}")
    if gap(fg, fc) > 0.05 * top or mean_gap > 0.05:
        fail(f"check: bf16 DGCNN features on the card off the CPU's by {gap(fg, fc)} "
             f"(mean {mean_gap})")
    if abs(lg - lc) > 2e-2 * abs(lc):       # bf16 products: 2% of the loss
        fail(f"check: DGCNN loss on the card {lg} disagrees with the CPU's {lc}")
    if min(used.values()) == 0:
        fail(f"check: a DGCNN kernel gate stayed closed: {used}")


def phase_dgcnn_train(torch, config, raw, device, card):
    steady, first, launches, peak, one_more = run_steps(torch, config, raw, device,
                                                        TRAIN_STEPS, SEED + 7)
    if min(launches[k] for k in DGCNN_COUNTERS) == 0:
        fail(f"train: a DGCNN kernel was never launched on the main path: {launches}")
    if launches["nn_half_tiled"] != TRAIN_STEPS:
        fail(f"train: the DGCNN chamfer did not take one launch a step: {launches}")
    log(f"  launches on the DGCNN path ({TRAIN_STEPS} steps): "
        f"{ {k: v for k, v in launches.items() if v} }")
    log(f"  [{card}] DGCNN step {steady * 1e3:.2f} ms (median of steps 2-{TRAIN_STEPS}), "
        f"{DGCNN_BATCH / steady:.1f} clouds/s, first step {first * 1e3:.1f} ms, "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    profile_step(torch, one_more, card,
                 expect=("knn_select_kernel", "edgeconv_bwd_kernel", "contrib_"))
    del one_more
    torch.cuda.empty_cache()

    # the data pipeline's share of the step: norm, affine_r3, dropout_local
    # (seven rounds of seed pick, distances and a stable sort) and two resamples
    from point_dae_torch.engine.pretrain import device_pipeline
    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    pipe_ms = cuda_ms(lambda: device_pipeline(raw, d["aug_type"], d["corrupt_type"],
                                              d["npoints"], generator=g, device=device), 5)
    log(f"  [{card}] DGCNN device_pipeline alone: {pipe_ms:.2f} ms a call (CUDA events "
        f"over 5 back-to-back calls, host gaps included)")

    exact = copy.deepcopy(config)
    exact["model"]["edgeconv_exact_grads"] = True
    log(f"  edgeconv_exact_grads, {EXACT_STEPS} steps:")
    steady_e, _, launches_e, _, _ = run_steps(torch, exact, raw, device, EXACT_STEPS,
                                              SEED + 7)
    if launches_e["knn_aggregate_bwd_split"] == 0 or launches_e["knn_aggregate_bwd_first"]:
        fail(f"train: edgeconv_exact_grads did not take the split backward: {launches_e}")
    log(f"  [{card}] DGCNN step with edgeconv_exact_grads {steady_e * 1e3:.2f} ms "
        f"(step 2 of {EXACT_STEPS})")
    launches["knn_aggregate_bwd_split"] = launches_e["knn_aggregate_bwd_split"]
    return launches, (steady, peak)


def on_device(obj, device):
    """A copy of a draws object (dataclasses, lists and tuples of them,
    tensors) with every tensor on ``device``."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: on_device(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(on_device(v, device) for v in obj)
    return obj.to(device) if hasattr(obj, "is_floating_point") else obj


def with_keys(config, keys):
    out = copy.deepcopy(config)
    out["model"]["transformer_config"].update(keys)
    return out


def phase_check(torch, config, raw, device):
    """Full-width forward at CHECK_BATCH on the card (kernels) and on the
    CPU (plain paths) with the same weights, points and draws."""
    from point_dae_torch.engine.pretrain import device_pipeline, init_model
    from point_dae_torch.utils import kernels

    cpu_model = init_model(config, seed=SEED + 2, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    _, clean = device_pipeline(raw[:CHECK_BATCH], d["aug_type"], d["corrupt_type"],
                               d["npoints"], generator=g, device=device)
    draws = gpu_model.sample_draws(CHECK_BATCH, g, device)
    before = dict(kernels.launches)
    with torch.no_grad():
        lg = [float(v) for v in gpu_model(clean, clean, draws=draws)]
        clean_cpu = clean.cpu()
        t0 = time.perf_counter()
        lc = [float(v) for v in cpu_model(clean_cpu, clean_cpu, draws=on_device(draws, "cpu"))]
    used = {k: kernels.launches[k] - before[k] for k in FLAGSHIP_COUNTERS}
    log(f"  batch {CHECK_BATCH}: card (kernels) loss_xyz {lg[0]:.6f} loss_global {lg[1]:.6f}; "
        f"cpu (plain, {time.perf_counter() - t0:.1f} s) {lc[0]:.6f} {lc[1]:.6f}; launches {used}")
    if not all(math.isfinite(v) for v in lg + lc):
        fail("check: non-finite loss")
    for a_, b_ in zip(lg, lc):
        if abs(a_ - b_) > 2e-2 * abs(b_):   # bf16 products: 2% of the loss
            fail(f"check: card losses {lg} disagree with the CPU's {lc}")
    if min(v for k, v in used.items() if not k.endswith("_bwd")) == 0:
        fail(f"check: a kernel gate stayed closed at batch {CHECK_BATCH}: {used}")


def run_steps(torch, config, raw, device, steps, seed, watch=None, model=None, labels=None):
    """``steps`` train steps of a freshly initialised model (or of
    ``model``): per-step host times (each ending in a synchronise), losses,
    the launch counters of those steps, the peak of max_memory_allocated,
    and a closure that takes one more step. ``watch(model)``, if given, is
    called on the model before the first step; ``labels`` go to each step
    (a supervised model's)."""
    from point_dae_torch.engine.pretrain import init_model, make_train_step
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.utils import kernels

    if model is None:
        model = init_model(config, seed=seed, device=device)
    if watch is not None:
        watch(model)
    state = TrainState.create(model, config, steps_per_epoch=100)
    step = make_train_step(model, config, device=device)
    g = torch.Generator(device=device).manual_seed(seed + 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, losses = [], []
    kw = {} if labels is None else {"labels": labels}
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step(state, raw, generator=g, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append((float(m["loss_xyz"]), float(m["loss_normal"])))
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    for i, (lx, ln) in enumerate(losses):
        log(f"  step {i}: loss_xyz {lx:.6f} loss_global {ln:.6f} ({times[i] * 1e3:.1f} ms)")
    if not all(math.isfinite(v) for pair in losses for v in pair):
        fail("train: non-finite loss")
    steady = sorted(times[1:])
    steady = (steady[(len(steady) - 1) // 2] + steady[len(steady) // 2]) / 2
    return steady, times[0], launches, peak, lambda: step(state, raw, generator=g, **kw)


def phase_train(torch, config, raw, device, card):
    steady, first, launches, peak, one_more = run_steps(torch, config, raw, device,
                                                        TRAIN_STEPS, SEED)
    if min(launches[k] for k in FLAGSHIP_COUNTERS) == 0:
        fail(f"train: a kernel was never launched on the main path: {launches}")
    if (launches["mlp_ln_fwd"], launches["mlp_ln_bwd"]) != (16 * TRAIN_STEPS,) * 2:
        fail(f"train: the flagship did not launch mlp_ln 16 times a step: {launches}")
    if launches["nn_half_small"] != TRAIN_STEPS:
        fail(f"train: the flagship's patch chamfer did not take one launch a step: {launches}")
    log(f"  launches on the main path ({TRAIN_STEPS} steps): "
        f"{ {k: launches[k] for k in FLAGSHIP_COUNTERS} }")
    log(f"  [{card}] step {steady * 1e3:.2f} ms (median of steps 2-{TRAIN_STEPS}), "
        f"{BATCH / steady:.1f} clouds/s, first step {first * 1e3:.1f} ms, "
        f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    profile_step(torch, one_more, card,
                 expect=("patchify_knn_rows", "mlp_fwd_ln_rows", "fold_bwd_rows", "attention_fwd"))
    del one_more
    torch.cuda.empty_cache()

    # the plain folding head (fold_impl xla) beside the kernel
    xla = copy.deepcopy(config)
    xla["model"]["transformer_config"]["fold_impl"] = "xla"
    log(f"  fold_impl xla, {XLA_STEPS} steps:")
    steady_x, _, launches_x, peak_x, one_more = run_steps(torch, xla, raw, device,
                                                          XLA_STEPS, SEED)
    if launches_x["folding_fwd"] or launches_x["folding_bwd"]:
        fail(f"train: fold_impl xla launched the folding kernel: {launches_x}")
    profile_step(torch, one_more, card, top=8)
    log(f"  [{card}] fold_impl auto (kernel) {steady * 1e3:.2f} ms a step, peak "
        f"{peak / 2 ** 30:.2f} GiB; fold_impl xla (plain head) {steady_x * 1e3:.2f} ms a step "
        f"(median of steps 2-{XLA_STEPS}), peak {peak_x / 2 ** 30:.2f} GiB")
    return launches, (steady, peak)


def profile_step(torch, run, card, top: int = 25, expect=()):
    """Device time by kernel over one more step, under torch.profiler (which
    slows the host side, so the busy share is a lower bound). Returns (busy
    microseconds, microseconds by ported kernel). Each name of ``expect``
    must have device time in the window: else the step is profiled again,
    and after PROFILE_WINDOWS windows the run fails."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prime_profiler(torch)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = window_kernels(torch, prof.key_averages())
        missing = [n for n in expect if not any(n in e.key for e in events)]
        recorded, launched = launch_balance(prof.key_averages(), events)
        if events and not missing:
            break
        log(f"  profiler window {attempt} of a step recorded no device time for "
            f"{missing or 'any kernel'} ({recorded} kernel records of {launched} launches)")
    else:
        fail(f"profiled step: {PROFILE_WINDOWS} windows recorded no device time for "
             f"{missing or 'any kernel'}")
    busy = sum(dev_us(e) for e in events)
    ours = {"mlp_": 0.0, "patchify_": 0.0,
            "gather_rows_kernel": 0.0, "nn_half_small_kernel": 0.0,
            "fold_fwd_kernel": 0.0, "fold_bwd_rows_kernel": 0.0,
            "fold_bwd_weights_kernel": 0.0, "::gemm_kernel<": 0.0,
            "fold_sum_partials_kernel": 0.0,
            "attention_fwd": 0.0, "attention_bwd": 0.0,
            "knn_select_kernel": 0.0, "edgeconv_aggregate": 0.0,
            "gather_by_key_kernel": 0.0,
            "edgeconv_bwd_kernel": 0.0, "edgeconv_tie_weights_kernel": 0.0, "contrib_": 0.0,
            "row_sqnorm_kernel": 0.0,
            "nn_half_tiled_kernel": 0.0, "fps_kernel": 0.0, "scatter_count_kernel": 0.0,
            "scatter_place_kernel": 0.0, "scatter_sum_kernel": 0.0}
    for e in events:
        for k in ours:
            if k in e.key:
                ours[k] += dev_us(e)
    # the folding head's kernels: csrc/folding.cu's fold_* and its small GEMMs
    fold = sum(dev_us(e) for e in events if "fold_" in e.key or "::gemm_kernel<" in e.key)
    # csrc/mlp.cu's backward launches are mlp_bwd_*; the rest of mlp_* the forward
    mlp_bwd = sum(dev_us(e) for e in events if "mlp_bwd_" in e.key)
    log(f"  [{card}] profiled step: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f}%; {recorded} kernel records of "
        f"{launched} launches), folding kernels in total "
        f"{fold / 1e3:.2f} ms, mlp_ kernels {ours['mlp_'] / 1e3:.2f} ms (forward "
        f"{(ours['mlp_'] - mlp_bwd) / 1e3:.2f}, backward {mlp_bwd / 1e3:.2f}), ported kernels "
        + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in ours.items() if v))
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"    {dev_us(e) / 1e3:8.3f} ms {100 * dev_us(e) / busy:5.1f}% "
            f"x{e.count:<4d} {e.key[:110]}")
    return busy, ours


def ft_clouds(torch, name, batch, device, seed):
    """Random clouds of recipe ``name`` (numpy draws from ``seed``) and labels."""
    import numpy as np

    config, n_raw, _ = FINETUNES[name]
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.normal(size=(batch, n_raw, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, config["model"]["cls_dim"], size=(batch,)))
    return pts.to(device), labels.to(device)


# the fine-tune paths' FPS shapes (B 32): the DGCNN fine-tune train step (and
# its vote draws), its eval step, fine-tune A and C's resample, a cloud in the
# per-row gate, and one past a block's registers (no shipped config)
FPS_SHAPES = ((8192, 1200), (8192, 1024), (2048, 2048), (1200, 1024), (16384, 1024))
# forms the plan does not take at (32, 8192) -> 1200, held there too
FPS_EXTRA_PLANS = ((2, 128, 32), (8, 64, 16), (1, 256, 32))


def phase_fps_kernels(torch, device, parents):
    """The fps kernel against its plain version and the previous design
    (``parents["fps_parent"]``), picks equal bit for bit, at the recipes'
    shapes under the plan of each (clusters of four blocks at 8192 points,
    one block at 2048 and fewer) and at (32, 8192) -> 1200 also under the
    forms the plan does not take there (clusters of 2 and 8 blocks, one
    block), on clouds with duplicated and zeroed points; each shape's time
    beside the previous design's; and patchify at the PointTransformer's
    shape (G 128 of 2048) against its plain version and the previous
    design."""
    from point_dae_torch.ops import fps
    from point_dae_torch.tools import fps_ablation

    parent = parents["fps_parent"]
    g = torch.Generator(device=device).manual_seed(SEED + 20)
    rows = []
    for N, n in FPS_SHAPES:
        pts = torch.randn((FT_BATCH, N, 3), generator=g, device=device)
        pts[:, N // 2:N // 2 + N // 16] = pts[:, :N // 16]        # duplicated points
        pts[:, 5:9] = 0.0                                        # never selectable
        got, want = fps.fps_kernel(pts, n), fps.furthest_point_sample_plain(pts, n)
        prev = fps_ablation.parent_fps(parent, pts, n)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fps ({N} -> {n}): picks differ from the plain version (match "
                 f"{float((got == want).float().mean())})")
        if not torch.equal(got, prev):
            fail(f"fps ({N} -> {n}): picks differ from the previous design")
        if bool((got[:, 1:, None] == torch.arange(5, 9, device=device)).any()):
            fail(f"fps ({N} -> {n}): a zeroed point was picked")
        extra = []
        for q in FPS_EXTRA_PLANS if (N, n) == FPS_SHAPES[0] else ():
            q = fps.FpsPlan(*q)
            if not torch.equal(fps.fps_kernel(pts, n, use_plan=q), want):
                fail(f"fps ({N} -> {n}) under plan {tuple(q)}: picks differ from the plain "
                     f"version")
            extra.append(f"{tuple(q)} {cuda_ms(lambda: fps.fps_kernel(pts, n, use_plan=q), 5):.4f}")
        p = fps.plan(FT_BATCH, N, *fps.card(device))
        ms = cuda_ms(lambda: fps.fps_kernel(pts, n), 10)
        prev_ms = cuda_ms(lambda: fps_ablation.parent_fps(parent, pts, n), 5)
        plain = cuda_ms(lambda: fps.furthest_point_sample_plain(pts, n), 1)
        bound = bound_ms(pts.numel() * 4 + FT_BATCH * n * 4, FT_BATCH * N * n * 8, F32_FLOPS)
        rows.append((N, n, ms, plain, bound))
        log(f"  fps ({FT_BATCH}, {N}) -> {n}: {ms:.4f} ms, {ms / (n - 1) * 1e3:.3f} us an "
            f"iteration, plan {tuple(p)} ({p.form}) (previous design {prev_ms:.4f}, plain "
            f"{plain:.4f}, bound {bound[0]:.4f} by {bound[1]}), picks equal to both"
            + (f"; other plans, equal too: {', '.join(extra)} ms" if extra else ""))
        del pts
    check_patchify_g128(torch, torch.randn((FT_BATCH, 2048, 3), generator=g, device=device),
                        parents)
    N, n, ms, plain, bound = rows[0]
    return {"fps": dict(
        replaces="point_dae_tpu/ops/pallas_fps.py:15", source="point_dae_torch/csrc/fps.cu",
        max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None, bound=bound,
        note=f"B {FT_BATCH}, {N} -> {n} (the DGCNN fine-tune train step); picks equal to the "
             f"plain version's and the previous design's")}


def check_patchify_g128(torch, pts, parents):
    """patchify at G 128, S 32 of (B, 2048, 3) against its plain version
    (fps equal, kNN equal but at near-ties: selected distances to 1e-4) and
    bit for bit against the previous design, with its launches' device time."""
    from point_dae_torch.ops import patchify

    B = pts.shape[0]
    fk, kk, _, line = patchify_report(torch, pts, 128, 32, parents["patchify_parent"])
    fp, kp = patchify.fused_patchify_plain(pts, 128, 32)
    torch.cuda.synchronize()
    center = pts.gather(1, fk.long()[..., None].expand(-1, -1, 3))
    d = ((pts[:, None] - center[:, :, None]) ** 2).sum(-1)
    match = float((kk == kp).float().mean())
    if not (torch.equal(fk, fp) and match > 0.9999 and torch.allclose(
            d.gather(-1, kk.long()), d.gather(-1, kp.long()), rtol=1e-4, atol=1e-4)):
        fail(f"patchify at ({B}, 2048), G 128: differs from the plain version ({match})")
    bound = bound_ms(pts.numel() * 4 + fk.numel() * 4 + kk.numel() * 4, B * 128 * 2048 * 8,
                     F32_FLOPS)
    log(f"  patchify ({B}, 2048), G 128, S 32: {line} (plain "
        f"{cuda_ms(lambda: patchify.fused_patchify_plain(pts, 128, 32), 1):.4f}, bound "
        f"{bound[0]:.4f} by {bound[1]}), fps equal to the plain version's, knn idx match "
        f"{match:.6f}")


def dgcnn_feature_plain(torch, enc, x, inputs=None):
    """The DGCNN encoder's global feature through the fused EdgeConv kernel's
    plain version (the kernel's arithmetic: exact distances summed in
    channel order, BatchNorm statistics rebuilt from the aggregates), on
    whatever device ``x`` lies. Each EdgeConv layer's input is appended to
    ``inputs`` when a list is given."""
    from point_dae_torch.models.dgcnn import fused_edge_conv
    from point_dae_torch.models.layers import leaky_relu02

    feats = []
    for i in range(1, len(enc.WIDTHS) + 1):
        if inputs is not None:
            inputs.append(x)
        x = fused_edge_conv(x, getattr(enc, f"conv{i}")[0], getattr(enc, f"bn{i}"), enc.k,
                            enc.dtype, interpret=True, **enc.fused_flags)
        feats.append(x)
    return leaky_relu02(enc.bn5(enc.conv5[0](torch.cat(feats, -1)))).amax(1)


def knn_flips(torch, x, k):
    """Where the reference EdgeConv's kNN (clamped matrix-expansion distances,
    a stable sort) and the kernel's plain selection (exact distances summed
    in channel order) pick other neighbours on the same input x (B, N, C):
    (idx that differ by position, picks that differ as sets, the largest
    spread of the exact (f64) distances of the picks in the symmetric
    difference of a row, in units of 2^-24 (|x_i|^2 + |x_j|^2), the scale
    of one rounding of the expansion's terms, the (B, N) rows whose picks
    differ as sets)."""
    from point_dae_torch.ops.edgeconv import knn_select_plain
    from point_dae_torch.ops.geometry import knn

    ir = knn(x, x, k)[1].long()
    ip = knn_select_plain(x, k).long()
    by_pos = int((ir != ip).sum())
    r_out = ~(ir[..., :, None] == ip[..., None, :]).any(-1)    # ref picks the plain lacks
    p_out = ~(ip[..., :, None] == ir[..., None, :]).any(-1)
    apart = r_out.any(-1)
    b, i = apart.nonzero(as_tuple=True)
    if not len(b):
        return by_pos, 0, 0.0, apart
    x64 = x.double()
    sq = (x64 * x64).sum(-1)
    cand = torch.cat([ir[b, i], ip[b, i]], -1)                  # (rows, 2k)
    odd = torch.cat([r_out[b, i], p_out[b, i]], -1)
    d = ((x64[b[:, None], cand] - x64[b, i][:, None]) ** 2).sum(-1)
    scale = torch.where(odd, sq[b, i][:, None] + sq[b[:, None], cand], 0.0).amax(-1)
    spread = (torch.where(odd, d, -math.inf).amax(-1) - torch.where(odd, d, math.inf).amin(-1))
    return by_pos, int(r_out.sum()), float((spread / (scale * 2.0 ** -24)).max()), apart


def phase_finetune_check(torch, device):
    """Both fine-tune models at FT_CHECK_BATCH on the card (kernels) against
    the same weights on the CPU, f32: the resampled clouds equal (FPS picks
    bit for bit); eval logits against the CPU's plain path (the reference
    EdgeConv for B; for C, at 2048 points, the EdgeConv kernel's plain
    version, the reference's gap printed, with the neighbours on which the
    reference's kNN and the kernel's selection part on each EdgeConv layer's
    input, which must lie within rounding of each other) within 1e-3 of the
    largest logit;
    the train-mode loss with the same draws within 1e-3 of the loss, for B
    and C against the EdgeConv kernel's plain version: in train mode the BatchNorm statistics pool
    every point's k neighbours, so the neighbours that the reference's
    matmul distances and the kernel's exact ones order differently at a
    near-tie move the whole batch (on raw normal clouds the reference reads
    0.06% off the kernel's plain version on the CPU, the card 0.26% off the
    reference), while eval mode confines such a flip to its point."""
    from point_dae_torch.engine import finetune
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.models.common import ClsDraws
    from point_dae_torch.utils import kernels

    for name, (config, n_raw, smooth) in FINETUNES.items():
        t0 = time.perf_counter()
        pts, labels = ft_clouds(torch, name, FT_CHECK_BATCH, device, SEED + 21)
        pts_c, labels_c = pts.cpu(), labels.cpu()
        cpu_model = build_model_from_cfg(config["model"], device="cpu", seed=SEED + 22)
        gpu_model = copy.deepcopy(cpu_model).to(device)
        npoints = config["npoints"]
        before = kernels.launches["fps"]
        eg = finetune.make_eval_step(gpu_model, config, device=device)(pts).cpu()
        ec = finetune.make_eval_step(cpu_model, config, device="cpu")(pts_c)
        if name == "C":
            # at 2048 points the reference's matmul distances and the
            # kernel's exact ones order a near-tie differently often enough
            # to move a logit by 1e-3 of the largest (a run on an H100 host
            # read 1.05e-3, where on the same layer inputs the two
            # selections part on one pick as a set, in EdgeConv 2, whose
            # exact distances lie 0.9 units apart), so C's eval logits are
            # held to the kernel's plain version, the reference's gap and
            # the picks on which the two kNNs part printed
            inputs = []
            with torch.no_grad():
                pe = finetune.gather_points(pts_c, finetune.furthest_point_sample(
                    pts_c, npoints))
                ep = cpu_model.cls_head_finetune(
                    dgcnn_feature_plain(torch, cpu_model.dgcnn_encoder, pe, inputs))
            # the near-tie shown: on each EdgeConv layer's input of that eval
            # forward, the picks on which the reference's kNN and the
            # kernel's selection disagree lie within rounding of each other:
            # the spread of their exact distances is at most 2 (C + 2) units
            # (each side's error bound, C products and two sums)
            kk = cpu_model.dgcnn_encoder.k
            for layer, xin in enumerate(inputs, 1):
                by_pos, by_set, spread, _ = knn_flips(torch, xin, kk)
                C = xin.shape[-1]
                log(f"  C eval, EdgeConv {layer} (C {C}): kNN idx reference vs the kernel's "
                    f"plain selection differ at {by_pos} of {xin.shape[0] * xin.shape[1] * kk} "
                    f"positions, {by_set} picks as sets; exact distance spread of those "
                    f"picks at most {spread:.1f} units of 2^-24 (|x_i|^2 + |x_j|^2) "
                    f"(limit {2 * (C + 2)})")
                if spread > 2 * (C + 2):
                    fail(f"check C: EdgeConv {layer}'s reference and plain kNN differ off a "
                         f"near-tie ({spread:.1f} units)")
        gc = torch.Generator().manual_seed(SEED + 23)
        keep = finetune.point_all(npoints, n_raw)
        subset = finetune.sample_subset(FT_CHECK_BATCH, keep, npoints, gc, "cpu") \
            if keep > npoints else None
        dc = cpu_model.sample_draws(FT_CHECK_BATCH, gc, "cpu")
        dg = ClsDraws([m.to(device) for m in dc.dropout],
                      None if dc.drop_path is None else dc.drop_path.to(device))
        loss_fn = finetune.smooth_cross_entropy if smooth else finetune.cross_entropy
        with torch.no_grad():
            pc = finetune.fps_resample(pts_c, npoints, subset)
            pg = finetune.fps_resample(pts, npoints, None if subset is None else subset.to(device))
            cpu_model.train()
            gpu_model.train()
            if config["model"]["NAME"] == "DGCNN":
                feat = dgcnn_feature_plain(torch, cpu_model.dgcnn_encoder, pc)
                lc = float(loss_fn(cpu_model.cls_head_finetune(feat, dc.dropout), labels_c))
            else:
                lc = float(loss_fn(cpu_model(pc, draws=dc), labels_c))
            lg = float(loss_fn(gpu_model(pg, draws=dg), labels))
        used = kernels.launches["fps"] - before
        err = float((eg - ec).abs().max()) / float(ec.abs().max())
        ref = ""
        if name == "C":
            ref = f" (against the reference EdgeConv {err:.2e})"
            err = float((eg - ep).abs().max()) / float(ep.abs().max())
        log(f"  {name} batch {FT_CHECK_BATCH} ({time.perf_counter() - t0:.1f} s): eval logits "
            f"max |card - cpu| / max |cpu| {err:.2e}{ref}; train-mode loss card {lg:.6f} cpu "
            f"{lc:.6f}; fps launches {used}")
        if not torch.equal(pg.cpu(), pc):
            fail(f"check {name}: the resampled clouds differ between card and CPU")
        if not (math.isfinite(lg) and math.isfinite(lc) and torch.isfinite(eg).all()):
            fail(f"check {name}: non-finite logits or loss")
        if err > 1e-3 or abs(lg - lc) > 1e-3 * abs(lc):
            fail(f"check {name}: card and CPU disagree (logits {err:.2e}, loss {lg} vs {lc})")
        if used != 2:
            fail(f"check {name}: the fps kernel ran {used} times, expected 2")


def run_ft_steps(torch, config, pts, labels, device, steps, seed, smooth):
    """``steps`` fine-tune train steps of a freshly initialised model:
    (median of steps 2-, first step, launch counters of those steps, peak
    memory, model, a closure that takes one more step)."""
    from point_dae_torch.engine import finetune
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.utils import kernels

    model = build_model_from_cfg(config["model"], device=device, seed=seed)
    state = TrainState.create(model, config, steps_per_epoch=100,
                              grad_norm_clip=config["grad_norm_clip"])
    step = finetune.make_finetune_step(model, config, smooth=smooth, device=device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times, metrics = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = step(state, pts, labels, generator=g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append((float(m["loss"]), float(m["acc"])))
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    for i, (loss, acc) in enumerate(metrics):
        log(f"  step {i}: loss {loss:.6f} acc {acc:.2f} ({times[i] * 1e3:.1f} ms)")
    if not all(math.isfinite(v) for pair in metrics for v in pair):
        fail("finetune: non-finite loss")
    steady = sorted(times[1:])
    steady = (steady[(len(steady) - 1) // 2] + steady[len(steady) // 2]) / 2
    return steady, times[0], launches, peak, model, lambda: step(state, pts, labels, generator=g)


def timed(torch, fn):
    """(result, host milliseconds of fn ending in a synchronise)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_finetune(torch, device, card):
    """5 train steps of A and of B at batch 32, each with its counters zeroed
    before and read after; a profiled step; an eval step, a 10-draw vote
    step and the accuracy loop over two batches (the second a padded tail);
    then 2 steps of A in bf16. Returns the fps launches of the train runs."""
    import numpy as np
    from point_dae_torch.engine import finetune
    from point_dae_torch.ops import fps as fps_ops
    from point_dae_torch.utils import kernels

    fps_launches = 0
    for name, (config, n_raw, smooth) in FINETUNES.items():
        pts, labels = ft_clouds(torch, name, FT_BATCH, device, SEED + 30)
        log(f"  {name}: {config['model']['NAME']}, ({FT_BATCH}, {n_raw}, 3) -> "
            f"{config['npoints']} points, {FT_STEPS} steps:")
        steady, first, launches, peak, model, one_more = run_ft_steps(
            torch, config, pts, labels, device, FT_STEPS, SEED + 31, smooth)
        missing = [k for k in FT_COUNTERS[name] if launches[k] == 0]
        if missing or launches["fps"] != FT_STEPS:
            fail(f"finetune {name}: kernels not launched as expected on the main path: "
                 f"{launches}")
        fps_launches += launches["fps"]
        log(f"  launches on the {name} path ({FT_STEPS} steps): "
            f"{ {k: v for k, v in launches.items() if v} }")
        log(f"  [{card}] {name} train step {steady * 1e3:.2f} ms (median of steps "
            f"2-{FT_STEPS}), {FT_BATCH / steady:.1f} clouds/s, first step {first * 1e3:.1f} ms, "
            f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
        busy, ours = profile_step(torch, one_more, card, top=12, expect=FT_PROFILED[name])
        # the step's fps launch, one kernel of 0.7 ms, timed by CUDA events
        # over back-to-back calls: a profiler window of five such calls
        # opened right after the profiled step held none or one of their
        # kernel records in its first try in every run, and in three tries
        # in a row once
        keep = finetune.point_all(int(config["npoints"]), n_raw)
        fps_dev = cuda_ms(lambda: fps_ops.furthest_point_sample(pts[..., :3], keep), 5)
        log(f"  [{card}] {name} fps share of the profiled step's device time: "
            f"{100 * fps_dev * 1e3 / busy:.1f}% ({fps_dev:.3f} ms a call, CUDA events; the "
            f"step's window holds {ours['fps_kernel'] / 1e3:.3f} ms of it)")
        del one_more

        eval_step = finetune.make_eval_step(model, config, device=device)
        vote_step = finetune.make_vote_step(model, config, times=VOTE_TIMES, device=device)
        g = torch.Generator(device=device).manual_seed(SEED + 32)
        ms = {}
        for what, fn in (("eval", lambda: eval_step(pts)),
                         ("vote", lambda: vote_step(pts, generator=g))):
            timed(torch, fn)                               # warm-up
            kernels.reset_launches()
            out, ms[what] = timed(torch, fn)
            if (tuple(out.shape) != (FT_BATCH, config["model"]["cls_dim"])
                    or not bool(torch.isfinite(out).all())):
                fail(f"finetune {name}: bad {what} logits")
            want = 1 if what == "eval" else VOTE_TIMES
            if kernels.launches["fps"] != want:
                fail(f"finetune {name}: {what} step launched fps {kernels.launches['fps']} "
                     f"times, expected {want}")
        rng = np.random.default_rng(SEED + 33)
        batches = [{"points": rng.normal(size=(b, n_raw, 3)).astype(np.float32),
                    "label": rng.integers(0, config["model"]["cls_dim"], size=(b,))}
                   for b in (FT_BATCH, 20)]
        acc, acc_ms = timed(torch, lambda: finetune.evaluate(eval_step, batches, FT_BATCH))
        vacc, vacc_ms = timed(torch, lambda: finetune.vote_eval(vote_step, batches, FT_BATCH, g))
        log(f"  [{card}] {name} eval step {ms['eval']:.2f} ms, {VOTE_TIMES}-draw vote step "
            f"{ms['vote']:.2f} ms (host clock, second call); accuracy loop over "
            f"{FT_BATCH + 20} random clouds {acc:.2f}% ({acc_ms:.1f} ms), vote {vacc:.2f}% "
            f"({vacc_ms:.1f} ms)")
        del model, eval_step, vote_step, pts
        torch.cuda.empty_cache()

    # A in bf16 (tools/bench_downstream.py:78): T = 129 keeps the plain
    # attention (R = 2 x 129 is no multiple of 8) and R = 32 x 129 the plain MLP
    config, n_raw, smooth = FINETUNES["A"]
    bf = copy.deepcopy(config)
    bf["model"]["dtype"] = "bf16"
    pts, labels = ft_clouds(torch, "A", FT_BATCH, device, SEED + 34)
    log(f"  A in bf16, {FT_BF16_STEPS} steps:")
    steady, _, launches, peak, _, _ = run_ft_steps(torch, bf, pts, labels, device,
                                                   FT_BF16_STEPS, SEED + 31, smooth)
    opened = [k for k in ("attention_fwd", "attention_bwd", "mlp_ln_fwd", "mlp_ln_bwd")
              if launches[k]]
    if opened or launches["fps"] != FT_BF16_STEPS:
        fail(f"finetune A bf16: unexpected launches {launches}")
    log(f"  [{card}] A bf16 train step {steady * 1e3:.2f} ms (step 2), peak "
        f"{peak / 2 ** 30:.2f} GiB; launches { {k: v for k, v in launches.items() if v} }")
    return fps_launches


# csrc/scatter.cu's launches, and those of its previous design
SCATTER_SPLIT = (("count", "scatter_count"), ("place", "scatter_place"),
                 ("sums", "scatter_sum"))
SCATTER_PARENT_SPLIT = (("sort", "sort_rows"), ("sums", "sum_rows"))


def phase_scatter_kernels(torch, device, card, parents):
    """scatter_rows_add at the two part-segmentation shapes, on real
    indices: PointTransformerPartSeg's interpolation (three_nn of 2048
    points to their 128 FPS centres: B 16, Q 6144, N 128, C 1152) and
    DGCNNPartSeg's edge gather (kNN, k 20, of a random (16, 2048, 3) cloud:
    Q 40960, N 2048, C 64), g random f32, and bf16 at the DGCNN shape.
    Held bit for bit against the plain version on the CPU (each element
    summed in ascending q) and the same bits on a second launch; the gap of
    the card's index_add_ (atomics, no fixed order) is printed. Times: the
    kernel, the plain version (scatter_add_ on the card) and index_add_
    (one call over the flattened rows); held bit for bit against the previous
    design too (``parents["scatter_parent"]``, built from
    point_dae_torch/tools/scatter_parent.cu), each design's device time by
    launch (count, place, sums; the previous design's sort, sums).
    Then the forward kernels of the two
    paths at their shapes: gather_rows_small_c of the (16, 2048, 3) cloud
    by its kNN rows (DGCNNPartSeg's first edge gather), equal to its plain
    version, and patchify at (16, 2048), G 128, S 32."""
    from point_dae_torch.ops import gather
    from point_dae_torch.ops.geometry import fps_knn, knn, three_nn
    from point_dae_torch.tools import rowreduce_ablation

    g_ = torch.Generator(device=device).manual_seed(SEED + 40)
    pts = torch.randn((PS_BATCH, PS_POINTS, 3), generator=g_, device=device)
    _, center, _ = fps_knn(pts, 128, 32)
    idx_pt = three_nn(pts, center)[1].reshape(PS_BATCH, -1)
    idx_dg = knn(pts, pts, 20)[1].reshape(PS_BATCH, -1)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0, flops=0.0, err=0.0)
    for name, idx, N, C, dtype in (("PT", idx_pt, 128, 1152, torch.float32),
                                   ("DGCNN", idx_dg, 2048, 64, torch.float32),
                                   ("DGCNN bf16", idx_dg, 2048, 64, torch.bfloat16)):
        B, Q = idx.shape
        g = torch.randn((B, Q, C), generator=g_, device=device).to(dtype)
        got = gather.scatter_rows_add(idx, g, N)
        again = gather.scatter_rows_add(idx, g, N)
        want = gather.scatter_rows_add_plain(idx.cpu(), g.cpu(), N)
        flat = (idx.long() + N * torch.arange(B, device=device)[:, None]).reshape(-1)
        gf = g.reshape(B * Q, C)

        def library():
            return torch.zeros((B * N, C), dtype=dtype, device=device).index_add_(0, flat, gf)

        lib = library().float().reshape(B, N, C)
        torch.cuda.synchronize()
        top = float(want.abs().max())
        lib_err = float((lib.cpu() - want).abs().max())
        if not torch.equal(got.cpu(), want):
            fail(f"scatter_rows_add {name}: differs from the plain version on the CPU (max "
                 f"{float((got.cpu() - want).abs().max())})")
        if not torch.equal(got, again):
            fail(f"scatter_rows_add {name}: two launches differ in their bits")
        idx32 = idx.int().contiguous()

        def previous():
            return rowreduce_ablation.parent_scatter(parents["scatter_parent"], idx32, g, N)

        if not torch.equal(previous(), got):
            fail(f"scatter_rows_add {name}: differs from the previous design in its bits")
        split = device_split(lambda: gather.scatter_rows_add(idx, g, N), SCATTER_SPLIT, 10,
                             f"scatter_rows_add {name}")
        prev_split = device_split(previous, SCATTER_PARENT_SPLIT, 10,
                                  f"the previous scatter_rows_add {name}")
        hub = int(torch.bincount(idx[0].long(), minlength=N).max())
        ms = cuda_ms(lambda: gather.scatter_rows_add(idx, g, N), 20)
        plain = cuda_ms(lambda: gather.scatter_rows_add_plain(idx, g, N), 5)
        lib_ms = cuda_ms(library, 20)
        nbytes = g.numel() * g.element_size() + idx.numel() * 4 + B * N * C * 4
        bound = bound_ms(nbytes, B * Q * C, F32_FLOPS)
        log(f"  [{card}] scatter_rows_add {name} (B {B}, Q {Q}, N {N}, C {C}, {str(dtype)[6:]}): "
            f"{ms:.4f} ms (plain {plain:.4f}, index_add_ {lib_ms:.4f}, bound {bound[0]:.4f} by "
            f"{bound[1]}), device {split['total']:.4f} ({split_line(split)}), previous design "
            f"device {prev_split['total']:.4f} ({split_line(prev_split)}); bit for bit with "
            f"the CPU and the previous design, index_add_ off by {lib_err:.2e} of "
            f"{top:.2f}; most contributors of a row {hub}")
        if dtype == torch.float32:
            tot["err"] = max(tot["err"], float((got.cpu() - want).abs().max()))
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib_ms),
                         ("nbytes", nbytes), ("flops", B * Q * C)):
                tot[k] += v
        del g, got, again, want, lib
        torch.cuda.empty_cache()

    B, Q = idx_dg.shape
    want = gather.gather_rows_small_c_plain(pts, idx_dg)
    if not (torch.equal(gather.gather_rows_small_c(pts, idx_dg), want)
            and torch.equal(gather.gather_rows_small_c(pts, idx_dg.long()), want)):
        fail("gather_rows_small_c at the DGCNN partseg shape: differs from the plain version")
    bound = bound_ms(pts.numel() * 4 + idx_dg.numel() * 4 + idx_dg.numel() * 12, 0, F32_FLOPS)
    log(f"  [{card}] gather_rows_small_c (B {B}, N {PS_POINTS}, C 3) by {Q} rows: "
        f"{gather_line(gather_times(torch, pts, idx_dg))}; bound {bound[0]:.4f} by {bound[1]}; "
        f"bit for bit, int32 and int64 indices")
    check_patchify_g128(torch, pts, parents)
    return {"scatter_rows_add": dict(
        replaces="point_dae_tpu/ops/pallas_scatter.py:24",
        source="point_dae_torch/csrc/scatter.cu", max_abs_err=tot["err"], ms=tot["ms"],
        plain_ms=tot["plain_ms"], library_ms=tot["library_ms"],
        bound=bound_ms(tot["nbytes"], tot["flops"], F32_FLOPS),
        note="f32, sum of one launch at each partseg shape (PT 16 x 6144 -> 128 x 1152, "
             "DGCNN 16 x 40960 -> 2048 x 64); bit for bit")}


def ps_batch(torch, batch, device, seed):
    """Random clouds (B, 2048, 3), category one-hots and per-point labels
    drawn from each category's parts (numpy draws from ``seed``)."""
    import numpy as np
    from point_dae_torch.engine.partseg import SEG_CLASSES

    rng = np.random.default_rng(seed)
    names = sorted(SEG_CLASSES)
    labels = rng.integers(0, 16, size=(batch,))
    seg = np.stack([rng.choice(SEG_CLASSES[names[l]], size=PS_POINTS) for l in labels])
    pts = rng.normal(size=(batch, PS_POINTS, 3)).astype(np.float32)
    return {"points": pts, "label": labels, "seg": seg.astype(np.int64),
            "pts": torch.from_numpy(pts).to(device),
            "onehot": torch.from_numpy(np.eye(16, dtype=np.float32)[labels]).to(device),
            "seg_t": torch.from_numpy(seg).to(device)}


def phase_partseg_check(torch, device):
    """Both part-segmentation models at PS_CHECK_BATCH on the card against
    the same weights on the CPU, f32: eval log-probs within 1e-3 of the
    largest |log-prob|, the train-mode NLL with the same SegDraws within
    1e-3 relative; each path's forward kernels must have launched on the
    card. For DGCNN, how many of the first EdgeConv's kNN neighbours differ
    between the card's and the CPU's distance products (a near-tie may
    flip)."""
    from point_dae_torch.engine import partseg
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.models.partseg import SegDraws, seg_nll_loss
    from point_dae_torch.ops.geometry import knn
    from point_dae_torch.utils import kernels

    for name, (config, _, forward) in PARTSEGS.items():
        t0 = time.perf_counter()
        b = ps_batch(torch, PS_CHECK_BATCH, device, SEED + 41)
        cpu_model = build_model_from_cfg(config["model"], device="cpu", seed=SEED + 42)
        gpu_model = copy.deepcopy(cpu_model).to(device)
        before = dict(kernels.launches)
        eg = partseg.make_seg_eval_step(gpu_model, device=device)(b["pts"], b["onehot"]).cpu()
        ec = partseg.make_seg_eval_step(cpu_model, device="cpu")(b["pts"].cpu(),
                                                                b["onehot"].cpu())
        dc = SegDraws.sample(cpu_model, PS_CHECK_BATCH, PS_POINTS,
                             torch.Generator().manual_seed(SEED + 43), "cpu")
        dg = SegDraws(dc.scale.to(device), dc.shift.to(device),
                      None if dc.drop_path is None else dc.drop_path.to(device),
                      [m.to(device) for m in dc.dropout])
        with torch.no_grad():
            cpu_model.train()
            gpu_model.train()
            pc = partseg.scale_shift(b["pts"].cpu(), dc.scale, dc.shift)
            pg = partseg.scale_shift(b["pts"], dg.scale, dg.shift)
            lc = float(seg_nll_loss(cpu_model(pc, b["onehot"].cpu(), draws=dc), b["seg_t"].cpu()))
            lg = float(seg_nll_loss(gpu_model(pg, b["onehot"], draws=dg), b["seg_t"]))
        used = {k: kernels.launches[k] - before[k] for k in kernels.launches
                if kernels.launches[k] != before[k]}
        err = float((eg - ec).abs().max()) / float(ec.abs().max())
        flips = ""
        if name == "DGCNN":
            ik = knn(pg, pg, 20)[1].cpu()
            ic = knn(pc, pc, 20)[1]
            flips = (f"; first EdgeConv kNN neighbours that differ card vs cpu "
                     f"{int((ik != ic).sum())} of {ik.numel()} (as sets "
                     f"{int((ik.sort(-1).values != ic.sort(-1).values).sum())})")
        log(f"  {name} batch {PS_CHECK_BATCH} ({time.perf_counter() - t0:.1f} s): eval log-probs "
            f"max |card - cpu| / max |cpu| {err:.2e}; train-mode NLL card {lg:.6f} cpu "
            f"{lc:.6f}; launches {used}{flips}")
        if not (math.isfinite(lg) and math.isfinite(lc) and torch.isfinite(eg).all()):
            fail(f"check {name}: non-finite log-probs or loss")
        if min(used.get(k, 0) for k in forward) == 0:
            fail(f"check {name}: a kernel of the path did not launch: {used}")
        if err > 1e-3 or abs(lg - lc) > 1e-3 * abs(lc):
            fail(f"check {name}: card and CPU disagree (log-probs {err:.2e}, NLL {lg} vs {lc})")
        del cpu_model, gpu_model
        torch.cuda.empty_cache()


def phase_partseg(torch, device, card):
    """5 train steps of each part-segmentation model at batch 16 of 2048
    points, counters zeroed before and read after; a profiled step; an eval
    step and the mIoU loop over two batches (the second a padded tail).
    Returns the scatter_rows_add launches of the train runs."""
    from point_dae_torch.engine import partseg
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.utils import kernels

    scatter = 0
    for name, (config, per_step, forward) in PARTSEGS.items():
        b = ps_batch(torch, PS_BATCH, device, SEED + 44)
        log(f"  {name}: {config['model']['NAME']}, ({PS_BATCH}, {PS_POINTS}, 3), "
            f"{PS_STEPS} steps:")
        model = build_model_from_cfg(config["model"], device=device, seed=SEED + 45)
        state = TrainState.create(model, config, steps_per_epoch=100,
                                  grad_norm_clip=config["grad_norm_clip"])
        step = partseg.make_seg_train_step(model, device=device)
        g = torch.Generator(device=device).manual_seed(SEED + 46)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        times, metrics = [], []
        for _ in range(PS_STEPS):
            t0 = time.perf_counter()
            m = step(state, b["pts"], b["onehot"], b["seg_t"], generator=g)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append((float(m["loss"]), float(m["acc"])))
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        for i, (loss, acc) in enumerate(metrics):
            log(f"  step {i}: loss {loss:.6f} acc {acc:.4f} ({times[i] * 1e3:.1f} ms)")
        if not all(math.isfinite(v) for pair in metrics for v in pair):
            fail(f"partseg {name}: non-finite loss")
        if (launches["scatter_rows_add"] != per_step * PS_STEPS
                or min(launches[k] for k in forward) == 0):
            fail(f"partseg {name}: kernels not launched as expected on the main path: "
                 f"{launches}")
        scatter += launches["scatter_rows_add"]
        steady = sorted(times[1:])
        steady = (steady[(len(steady) - 1) // 2] + steady[len(steady) // 2]) / 2
        log(f"  launches on the {name} path ({PS_STEPS} steps): "
            f"{ {k: v for k, v in launches.items() if v} }")
        log(f"  [{card}] {name} train step {steady * 1e3:.2f} ms (median of steps "
            f"2-{PS_STEPS}), {PS_BATCH / steady:.1f} shapes/s, first step {times[0] * 1e3:.1f} "
            f"ms, max_memory_allocated {peak / 2 ** 30:.2f} GiB")
        busy, ours = profile_step(torch, lambda: step(state, b["pts"], b["onehot"], b["seg_t"],
                                                      generator=g), card, top=15)
        sc = sum(ours[f"scatter_{k}_kernel"] for k in ("count", "place", "sum"))
        log(f"  [{card}] {name} scatter_rows_add share of the profiled step's device time: "
            f"{100 * sc / busy:.1f}% ({sc / 1e3:.3f} ms)")

        eval_step = partseg.make_seg_eval_step(model, device=device)
        timed(torch, lambda: eval_step(b["pts"], b["onehot"]))            # warm-up
        out, eval_ms = timed(torch, lambda: eval_step(b["pts"], b["onehot"]))
        if (tuple(out.shape) != (PS_BATCH, PS_POINTS, config["model"]["cls_dim"])
                or not bool(torch.isfinite(out).all())):
            fail(f"partseg {name}: bad eval log-probs")
        n_tail = PS_BATCH * 5 // 8
        tail = ps_batch(torch, n_tail, device, SEED + 47)
        batches = [{k: v for k, v in bb.items() if k in ("points", "label", "seg")}
                   for bb in (b, tail)]
        cat_names = sorted(partseg.SEG_CLASSES)
        miou, miou_ms = timed(torch, lambda: partseg.evaluate_partseg(
            eval_step, batches, PS_BATCH, cat_names))
        if not (0.0 <= miou["instance_miou"] <= 1.0 and 0.0 <= miou["class_miou"] <= 1.0):
            fail(f"partseg {name}: mIoU out of range: {miou}")
        log(f"  [{card}] {name} eval step {eval_ms:.2f} ms (host clock, second call); mIoU "
            f"loop over {PS_BATCH + n_tail} random shapes: instance {miou['instance_miou']:.5f}, "
            f"class {miou['class_miou']:.5f} ({miou_ms:.1f} ms)")
        del model, state, step, eval_step, b, tail
        torch.cuda.empty_cache()
    return scatter


# -- the in-model dropouts, MaskFeat_dgcnn, the hybrid EdgeConv kNN
DROPOUT_CFGS = (   # (shipped config, steps), trained from (128, 8192, 6) raw clouds
    ("cfgs/generated/pretrain_PointCAE_dropout_patch_pointmae.yaml", 5),
    ("cfgs/generated/pretrain_PointCAE_dropout_global_p3.yaml", 2),
    ("cfgs/generated/pretrain_PointCAE_affine_r3_dropout_patch_pointmae.yaml", 2))
DROPOUT_COUNTERS = ("patchify", "gather_rows_small_c", "key_gather", "knn_aggregate_fwd",
                    "knn_aggregate_bwd_first", "nn_half_tiled")
MASKFEAT_CFG = "cfgs/generated/pretrain_MaskSurf_dgcnn_crosspoint.yaml"
MASKFEAT_STEPS = 5
MASKFEAT_COUNTERS = ("fps", "knn", "gather_rows_small_c")
HYBRID_STEPS = 2           # DGCNN steps with edgeconv_knn: xla
FINETUNE_C_CFG = "cfgs/generated/finetune_scan_hardest_transferring_features_DGCNN.yaml"
DM_CHECK_BATCH = 8


def load_cfg(path):
    from point_dae_torch.utils.config import cfg_from_yaml_file

    return cfg_from_yaml_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), path))


def key_gather_report(torch, name, x, mask, g, card):
    """The key gather at one dropout shape, Q 1024: form (a) from the int64
    keys and ranks the previous resample built, form (b) from the mask with
    the f32 uniforms the dropouts draw and with int64 ranks, and
    ``resample_batch`` (mask in, rows out), each bit for bit with its plain
    twin and with each other, a cloud with no valid point giving zeros and
    the rest equal to the argsort-pack path of the CPU. The masked
    resample must be one kernel launch (torch.profiler, ``launches_a_call``).
    Returns (gather_by_mask ms a call, its plain twin's ms, its bound, its
    device ms); logs form (a)'s and resample_batch's times beside them."""
    from point_dae_torch.ops import gather
    from point_dae_torch.ops.geometry import resample_batch

    B, N, C = x.shape
    Q = 1024
    u = torch.rand((B, Q), generator=g, device=x.device)
    draw = gather.ranks_from_uniforms(mask, u)
    keys = torch.where(mask, torch.cumsum(mask.int(), 1) - 1, -1)
    want = gather.gather_by_key_plain(x, keys, draw)
    got = {"keys": gather.gather_by_key(x, keys, draw),
           "mask, uniforms": gather.gather_by_mask(x, mask, u),
           "mask, int64 ranks": gather.gather_by_mask(x, mask, draw),
           "resample_batch": resample_batch(x, mask, Q, draws=u)}
    twin = gather.gather_by_mask_plain(x, mask, u)
    packed = torch.gather(x, 1, torch.gather(
        torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices, 1,
        draw)[..., None].expand(-1, -1, C))
    torch.cuda.synchronize()
    if not torch.equal(twin, want):
        fail(f"key_gather {name}: the two plain twins differ")
    for form, out in got.items():
        if not torch.equal(out, want):
            fail(f"key_gather {name}: {form} differs from the plain version")
    empty = mask.sum(1) == 0
    if empty.any() and got["mask, uniforms"][empty].any():
        fail(f"key_gather {name}: a cloud with no valid point did not give zeros")
    if not torch.equal(want[~empty], packed[~empty]):
        fail(f"key_gather {name}: differs from the argsort-pack path")
    per_call = launches_a_call(torch, lambda: resample_batch(x, mask, Q, draws=u), 20,
                               f"resample_batch {name}")
    if per_call != 1:
        fail(f"key_gather {name}: a masked resample_batch made {per_call} kernel launches, "
             f"not one")

    def form_b():
        return gather.gather_by_mask(x, mask, u)

    def form_a():
        return gather.gather_by_key(x, keys, draw)

    ms = cuda_ms(form_b, 50)
    ms_a = cuda_ms(form_a, 50)
    ms_r = cuda_ms(lambda: resample_batch(x, mask, Q, draws=u), 50)
    dev = device_split(form_b, (("kernel", "gather_by_key_kernel"),), 20, f"key_gather {name}")
    dev_a = device_split(form_a, (("kernel", "gather_by_key_kernel"),), 20,
                         f"key_gather keys {name}")
    plain = cuda_ms(lambda: gather.gather_by_mask_plain(x, mask, u), 20)
    pack_ms = cuda_ms(lambda: torch.gather(x, 1, torch.gather(
        torch.sort((~mask).to(torch.uint8), dim=1, stable=True).indices, 1,
        gather.ranks_from_uniforms(mask, u))[..., None].expand(-1, -1, C)), 20)
    # bytes: the mask (or int64 keys) and the draws once, the output once, each
    # selected row once (the distinct rows this run's draws pick)
    picked = torch.where(draw < mask.sum(1, keepdim=True),
                         torch.arange(B, device=x.device)[:, None] * N + draw, -1)
    rows_once = (int(torch.unique(picked).numel()) - int(bool((picked < 0).any()))) * C * 4
    out_bytes = B * Q * C * 4
    bound = bound_ms(mask.numel() + u.numel() * 4 + out_bytes + rows_once, 0, F32_FLOPS)
    bound_a = bound_ms(keys.numel() * 8 + draw.numel() * 8 + out_bytes + rows_once, 0,
                       F32_FLOPS)
    log(f"  [{card}] key_gather {name} ({B}, {N}, {C}) -> {Q}, a masked resample "
        f"{per_call} launch: from the mask and f32 uniforms {ms:.4f} ms a call, device "
        f"{dev['total']:.4f} ({split_line(dev)}), bound {bound[0]:.4f} by {bound[1]}; "
        f"from int64 keys and ranks {ms_a:.4f} ms, device {dev_a['total']:.4f}, bound "
        f"{bound_a[0]:.4f}; resample_batch {ms_r:.4f} ms a call; plain twin {plain:.4f}, "
        f"argsort-pack path {pack_ms:.4f}; every form bit for bit with the plain "
        f"version and the argsort-pack path")
    return ms, plain, bound, dev["total"]


def launches_a_call(torch, fn, calls: int, what: str) -> float:
    """Kernel launches a call of fn under torch.profiler: the launch records
    (cudaLaunchKernel and its variants) over ``calls`` calls, after one
    warm-up, each window primed as ``kernel_events`` primes it, the
    primer's launches left out; a window whose kernel records fall short of
    its launch records is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prime_profiler(torch)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        records = prof.key_averages()
        launched = sum(e.count for e in records
                       if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
        launched = max(launched - PRIMER_LAUNCHES, 0)
        recorded, _ = launch_balance(records, window_kernels(torch, records))
        if recorded >= 0.95 * launched and launched:
            return launched / calls
        log(f"  profiler window {attempt} of {what} holds {recorded} kernel records of "
            f"{launched} launches")
    fail(f"launches of {what}: {PROFILE_WINDOWS} torch.profiler windows in a row lost "
         f"kernel records")


def phase_key_knn_kernels(torch, device, card, parents):
    """key_gather, knn and aggregate_from_idx against their plain versions on the card
    at the paths' shapes, and knn_aggregate above 1024 points:

    - key_gather at the dropout_patch_pointmae shape ((128, 2048, 3) -> 1024,
      the patches of a 64-patch mask with about half kept) and the
      dropout_global_p3 shape ((128, 1024, 3) -> 1024, 716 kept), both forms
      (``key_gather_report``);
    - knn at MaskFeat_dgcnn's five shapes: 64 FPS centres in 1024 points, C
      3, k 32, and the teacher's four EdgeConv kNNs, (128, 1024, 1024) at C
      3 / 64 / 64 / 128, k 20: idx equal but at counted distance ties, dists
      within 1e-5 relative; torch.topk over torch.cdist timed beside it;
    - aggregate_from_idx at the DGCNN step's four shapes (128, 1024, C 64 /
      64 / 128 / 256, k 20, over the plain kNN's idx): bit for bit with its
      plain version, with knn_aggregate's aggregates and with the previous
      design (``parents["aggregate_parent"]``);
    - knn_aggregate at (32, 2048, C 64, k 20), the shipped ScanObjectNN
      DGCNN fine-tune's clouds, and at (4, 4096, C 64, k 20): forward bit for
      bit with the plain version on the card, both backwards bit for bit
      with the plain version on the CPU (each sum in (source, round) order),
      the same bits on a second launch; the aggregate alone against the
      previous design (aggregate_report)."""
    from point_dae_torch.ops import edgeconv, tiled_knn as knn_ops
    from point_dae_torch.ops.geometry import fps_knn, group_points
    from point_dae_torch.tools import rowreduce_ablation

    records = {}
    g = torch.Generator(device=device).manual_seed(SEED + 60)
    B = DGCNN_BATCH

    # -- key gather
    pts = torch.randn((B, 1024, 3), generator=g, device=device)
    _, _, pidx = fps_knn(pts, 64, 32)
    flat = group_points(pts, pidx).reshape(B, 2048, 3).contiguous()
    keep = torch.rand((64,), generator=g, device=device) > 0.5
    keep[0] = True
    mask_p = keep[None, :, None].expand(B, 64, 32).reshape(B, 2048).clone()
    mask_p[5] = False                                      # no valid point: zeros
    rank_u = torch.rand((B, 1024), generator=g, device=device)
    order = torch.argsort(rank_u, dim=-1, stable=True)
    mask_g = torch.empty_like(order).scatter_(
        1, order, torch.arange(1024, device=device).expand(B, -1)) < int(1024 * (1.0 - 0.3))
    rows = []
    for name, x, mask in (("patch", flat, mask_p), ("global_p3", pts, mask_g)):
        rows.append(key_gather_report(torch, name, x, mask, g, card))
    (ms, plain, bound, dev), other = rows
    records["key_gather"] = dict(
        replaces="point_dae_tpu/ops/pallas_scatter.py:176",
        source="point_dae_torch/csrc/gather.cu", max_abs_err=0.0, ms=ms, plain_ms=plain,
        library_ms=None, bound=bound,
        note=f"gather_by_mask (mask and f32 uniforms, the dropouts' call) at the "
             f"dropout_patch_pointmae shape (128, 2048, 3) -> 1024, device {dev:.4f} ms "
             f"(dropout_global_p3 shape {other[3]:.4f}); no single PyTorch call")
    del flat, pidx

    # -- knn at MaskFeat's five shapes
    center = pts[:, :64].contiguous()
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0, flops=0.0, err=0.0)
    ties = 0
    for Cq, q, y, k in ((3, center, pts, 32), (3, pts, pts, 20),
                        (64, None, None, 20), (64, None, None, 20), (128, None, None, 20)):
        if q is None:
            y = torch.randn((B, 1024, Cq), generator=g, device=device)
            y[:, 512:520] = y[:, :8]                           # duplicated rows: ties
            q = y
        dk, ik = knn_ops.knn_kernel(q, y, k)
        dp, ip = knn_ops.knn_plain(q, y, k)
        torch.cuda.synchronize()
        differ = ik != ip
        n_diff = int(differ.sum())
        rel = float(((dk - dp).abs() / dp.abs().clamp_min(1e-30)).max())
        if rel > 1e-5 or (n_diff and not torch.equal(dk[differ], dp[differ])):
            fail(f"knn (C {Cq}, k {k}): dists off by {rel:.2e} or idx differ off a tie")
        ties += n_diff
        tot["err"] = max(tot["err"], float((dk - dp).abs().max()))
        tot["ms"] += cuda_ms(lambda: knn_ops.knn_kernel(q, y, k), 10)
        tot["plain_ms"] += cuda_ms(lambda: knn_ops.knn_plain(q, y, k), 1)
        tot["library_ms"] += cuda_ms(
            lambda: torch.topk(torch.cdist(q, y), k, dim=-1, largest=False), 5)
        tot["nbytes"] += (q.numel() + y.numel()) * 4 + B * q.shape[1] * k * 8
        tot["flops"] += B * q.shape[1] * y.shape[1] * (2 * Cq + 3)
        del dk, ik, dp, ip
    records["knn"] = dict(
        replaces="point_dae_tpu/ops/pallas_knn.py:18", source="point_dae_torch/csrc/edgeconv.cu",
        max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
        library_ms=tot["library_ms"], bound=bound_ms(tot["nbytes"], tot["flops"], F32_FLOPS),
        note=f"sum of a MaskFeat_dgcnn step's five shapes; idx differ at {ties} ties")
    log(f"  knn: idx that differ from the plain version (at distance ties) {ties}")
    torch.cuda.empty_cache()

    # -- aggregate_from_idx at the DGCNN step's four shapes
    tot = dict(ms=0.0, plain_ms=0.0, nbytes=0.0)
    for Cf, C in ((3, 64), (64, 64), (64, 128), (128, 256)):
        xf = pts if Cf == 3 else torch.randn((B, 1024, Cf), generator=g, device=device)
        U = torch.randn((B, 1024, C), generator=g, device=device).bfloat16().float()
        idx = edgeconv.knn_select_plain(xf, 20)
        out = edgeconv.aggregate_fwd_kernel(U, idx, True)
        want = edgeconv.aggregate_plain(U, idx)
        fused = edgeconv.knn_aggregate_fwd_kernel(U, xf, 20, True)
        torch.cuda.synchronize()
        if not all(torch.equal(a.to(b.dtype), b) for a, b in zip(out, want)):
            fail(f"aggregate_from_idx C {C}: differs from the plain version")
        if not all(torch.equal(a, b) for a, b in zip(out[:4], fused[:4])):
            fail(f"aggregate_from_idx C {C}: differs from knn_aggregate's aggregates")
        prev = rowreduce_ablation.parent_aggregate(parents["aggregate_parent"], U, idx, True)
        if not all(torch.equal(a, b) for a, b in zip(out, prev)):
            fail(f"aggregate_from_idx C {C}: differs from the previous design in its bits")
        tot["ms"] += cuda_ms(lambda: edgeconv.aggregate_fwd_kernel(U, idx, True), 10)
        tot["plain_ms"] += cuda_ms(lambda: edgeconv.aggregate_plain(U, idx), 2)
        tot["nbytes"] += B * 1024 * (C * 4 + 20 * 4 + 4 * C * 4 + 2 * C)
        del out, want, fused
    records["aggregate_from_idx"] = dict(
        replaces="point_dae_tpu/ops/pallas_edgeconv.py:295",
        source="point_dae_torch/csrc/edgeconv.cu", max_abs_err=0.0, ms=tot["ms"],
        plain_ms=tot["plain_ms"], library_ms=None,
        bound=bound_ms(tot["nbytes"], B * 1024 * 20 * 256 * 4, F32_FLOPS),
        note="sum of the DGCNN step's four shapes; bit for bit; no single PyTorch call")
    del pts, center
    torch.cuda.empty_cache()

    # -- knn_aggregate above 1024 points
    for Bn, N in ((FT_BATCH, 2048), (4, 4096)):
        C, k = 64, 20
        xf = torch.randn((Bn, N, C), generator=g, device=device)
        xf[:, N - 64:] = xf[:, :64]                          # duplicated rows: ties
        U = torch.randn((Bn, N, C), generator=g, device=device)
        U[:, N - 64:] = U[:, :64]
        cots = [torch.randn((Bn, N, C), generator=g, device=device) for _ in range(4)]
        outk = edgeconv.knn_aggregate_fwd_kernel(U, xf, k, True)
        idx = edgeconv.knn_select_plain(xf, k)
        outp = edgeconv.aggregate_plain(U, idx)
        torch.cuda.synchronize()
        if not torch.equal(outk[4], idx):
            fail(f"knn_aggregate N {N}: neighbours differ from the plain version")
        for nm, a, b in zip(("M", "m", "S1", "S2", "rM", "rm"), outk[:4] + outk[5:], outp):
            if not torch.equal(a.to(b.dtype), b):
                fail(f"knn_aggregate N {N}: {nm} differs from the plain version")
        M, m, _, _, _, rM, rm = outk
        cpu = [t.cpu() for t in cots]
        fwd_work, bwd_work = edgeconv_work(Bn, N, C, C, k)
        ms = {"fwd": cuda_ms(lambda: edgeconv.knn_aggregate_fwd_kernel(U, xf, k, True), 3)}
        plain_ms = {"fwd": cuda_ms(lambda: edgeconv.aggregate_plain(
            U, edgeconv.knn_select_plain(xf, k)), 1)}
        bounds = {"fwd": bound_ms(*fwd_work, F32_FLOPS)}
        splits = {}
        for mode, a, c, plain in (("first", rM, rm, edgeconv.bwd_first_plain),
                                  ("split", M, m, edgeconv.bwd_split_plain)):
            run = lambda: edgeconv.knn_aggregate_bwd_kernel(mode, U, idx, a, c, *cots)
            du, du2 = run(), run()
            want = plain(U.cpu(), idx.cpu(), a.cpu(), c.cpu(), *cpu)
            if not torch.equal(du.cpu(), want):
                fail(f"knn_aggregate N {N} bwd {mode}: differs from the plain version on "
                     f"the CPU (max {float((du.cpu() - want).abs().max())})")
            if not torch.equal(du, du2):
                fail(f"knn_aggregate N {N} bwd {mode}: two launches differ in their bits")
            ms[mode] = cuda_ms(run, 3)
            plain_ms[mode] = cuda_ms(lambda: plain(U, idx, a, c, *cots), 1)
            bounds[mode] = bound_ms(*bwd_work, F32_FLOPS)
            splits[mode] = split_line(device_split(run, EDGECONV_SPLIT,
                                                   what=f"knn_aggregate bwd {mode} N {N}"))
        splits["fwd"] = split_line(device_split(
            lambda: edgeconv.knn_aggregate_fwd_kernel(U, xf, k, True), EDGECONV_SPLIT,
            what=f"knn_aggregate fwd N {N}"))
        a_ms, a_prev, a_bound, a_plan = aggregate_report(
            torch, U, idx, parents["aggregate_parent"], f"({Bn}, {N})")
        log(f"  [{card}] aggregate ({Bn}, {N}, C {C}, k {k}) (plan {tuple(a_plan)}): device "
            f"{a_ms:.4f} ms, previous design {ms_text(a_prev)}, bound {a_bound[0]:.4f} by "
            f"bytes; bit for bit with the previous design, track on and off")
        log(f"  [{card}] knn_aggregate ({Bn}, {N}, Cf {C}, C {C}, k {k}): "
            + "; ".join(f"{w} {ms[w]:.4f} ms (plain {plain_ms[w]:.4f}, bound "
                        f"{bounds[w][0]:.4f} by {bounds[w][1]}; device {splits[w]})"
                        for w in ("fwd", "first", "split"))
            + "; forward bit for bit with the plain version, both backwards (first, "
            "split) bit for bit with it on the CPU")
        del outk, outp, cots, cpu
        torch.cuda.empty_cache()
    return records


def check_fused_plain_loss(torch, model, cor, cln, draws):
    """A DGCNN DAE's training loss through the EdgeConv kernel's plain
    version: the in-model dropouts from ``draws``, the encoder as
    ``dgcnn_feature_plain``, the decoder and the chamfer."""
    from point_dae_torch.models.common import apply_input_dropout

    x = apply_input_dropout(cor[..., :3], model.corrupt_type, draws)
    feat = dgcnn_feature_plain(torch, model.dgcnn_encoder, x)
    coarse = model.recfc(feat).reshape(-1, model.num_coarse, 3)
    return model.loss_func(coarse, cln[..., :3].contiguous())


def phase_dropout_maskfeat_check(torch, raw, device):
    """Card against CPU, f32, same weights and draws:

    - the dropout_patch_pointmae DGCNN model at batch 8: the training loss on
      the card (patchify, EdgeConv and chamfer kernels) against the CPU
      through the EdgeConv kernel's plain version, within 1e-3 relative;
      then apply_input_dropout at batch 128 (every gate open: patchify,
      small-C gather, key gather), dropout_global_p3 bit for bit and
      dropout_patch_pointmae with at least 99.9% of the points equal (the
      patchify kernel and the CPU's kNN may order a near-tie differently);
    - MaskFeat_dgcnn at batch 8: the training loss within 1e-3 relative
      (fps, knn kernels on the card)."""
    from point_dae_torch.engine.pretrain import device_pipeline, init_model
    from point_dae_torch.models.common import apply_input_dropout, sample_dropout_draws
    from point_dae_torch.models.transformer import ModelDraws
    from point_dae_torch.utils import kernels

    config = load_cfg(DROPOUT_CFGS[0][0])
    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED + 61)
    cor, cln = device_pipeline(raw, d["aug_type"], d["corrupt_type"], d["npoints"],
                               generator=g, device=device)
    t0 = time.perf_counter()
    cpu_model = init_model(config, seed=SEED + 62, device="cpu").train()
    gpu_model = copy.deepcopy(cpu_model).to(device).train()
    draws = gpu_model.sample_draws(DM_CHECK_BATCH, g, device)
    cpu_draws = [copy.deepcopy(dr) for dr in draws]
    for dr in cpu_draws:
        for f in ("resample", "level", "patch_u", "rank_u", "coin"):
            v = getattr(dr, f)
            setattr(dr, f, None if v is None else v.cpu())
    before = dict(kernels.launches)
    with torch.no_grad():
        lg = float(gpu_model(cor[:DM_CHECK_BATCH], cln[:DM_CHECK_BATCH], draws=draws)[0])
        lc = float(check_fused_plain_loss(torch, cpu_model, cor[:DM_CHECK_BATCH].cpu(),
                                          cln[:DM_CHECK_BATCH].cpu(), cpu_draws))
    used = {k: kernels.launches[k] - before[k] for k in kernels.launches
            if kernels.launches[k] != before[k]}
    log(f"  dropout_patch_pointmae batch {DM_CHECK_BATCH} ({time.perf_counter() - t0:.1f} s): "
        f"loss card {lg:.6f} cpu (the EdgeConv kernel's plain version) {lc:.6f}; "
        f"launches {used}")
    if not (math.isfinite(lg) and math.isfinite(lc)) or abs(lg - lc) > 1e-3 * abs(lc):
        fail(f"check: dropout DGCNN loss on the card {lg} vs the CPU's {lc}")

    x = cor[..., :3].contiguous()
    before = dict(kernels.launches)
    for item, exact in (("dropout_global_p3", True), ("dropout_patch_pointmae", False)):
        dr = sample_dropout_draws(item, DGCNN_BATCH, 1024, g, device)
        dc = copy.deepcopy(dr)
        for f in ("resample", "level", "patch_u", "rank_u"):
            v = getattr(dc, f)
            setattr(dc, f, None if v is None else v.cpu())
        got = apply_input_dropout(x, [item], [dr]).cpu()
        want = apply_input_dropout(x.cpu(), [item], [dc])
        same = float((got == want).all(-1).float().mean())
        log(f"  {item} at batch {DGCNN_BATCH}: points equal card vs cpu {same:.6f}")
        if (exact and not torch.equal(got, want)) or same < 0.999:
            fail(f"check: {item} on the card differs from the CPU ({same})")
    used = {k: kernels.launches[k] - before[k] for k in ("patchify", "gather_rows_small_c",
                                                          "key_gather")}
    if min(used.values()) == 0:
        fail(f"check: a dropout kernel did not launch at batch {DGCNN_BATCH}: {used}")
    del cpu_model, gpu_model

    config = load_cfg(MASKFEAT_CFG)
    t0 = time.perf_counter()
    cpu_model = init_model(config, seed=SEED + 63, device="cpu").train()
    gpu_model = copy.deepcopy(cpu_model).to(device).train()
    draws = gpu_model.sample_draws(DM_CHECK_BATCH, g, device)
    cpu_draws = ModelDraws(draws.mask.cpu(), None, draws.dp_encoder.cpu(),
                           None if draws.dp_decoder is None else draws.dp_decoder.cpu())
    pts = cln[:DM_CHECK_BATCH, :, :3].contiguous()
    before = dict(kernels.launches)
    with torch.no_grad():
        lg = float(gpu_model(pts, pts, draws=draws)[0])
        lc = float(cpu_model(pts.cpu(), pts.cpu(), draws=cpu_draws)[0])
    used = {k: kernels.launches[k] - before[k] for k in kernels.launches
            if kernels.launches[k] != before[k]}
    log(f"  MaskFeat_dgcnn batch {DM_CHECK_BATCH} ({time.perf_counter() - t0:.1f} s): loss card "
        f"{lg:.6f} cpu {lc:.6f}; launches {used}")
    if not (math.isfinite(lg) and math.isfinite(lc)) or abs(lg - lc) > 1e-3 * abs(lc):
        fail(f"check: MaskFeat_dgcnn loss on the card {lg} vs the CPU's {lc}")
    if used.get("knn", 0) != 5 or used.get("fps", 0) != 1:
        fail(f"check: MaskFeat_dgcnn did not launch knn 5 times and fps once: {used}")


def phase_dropout_maskfeat_train(torch, raw, device, card):
    """The dropout configs' steps (counters zeroed before, read after; a
    profiled step of the first), then MaskFeat_dgcnn's. Returns the
    counters of the dropout_patch_pointmae run and of the MaskFeat run."""
    out = {}
    for i, (path, steps) in enumerate(DROPOUT_CFGS):
        config = load_cfg(path)
        log(f"  {os.path.basename(path)}, {steps} steps:")
        steady, first, launches, peak, one_more = run_steps(torch, config, raw, device,
                                                            steps, SEED + 64)
        want = DROPOUT_COUNTERS if "patch" in path else ("key_gather", "knn_aggregate_fwd")
        if min(launches[k] for k in want) == 0:
            fail(f"train: {path} did not launch every kernel of its path: {launches}")
        log(f"  launches ({steps} steps): { {k: v for k, v in launches.items() if v} }")
        log(f"  [{card}] {os.path.basename(path)} step {steady * 1e3:.2f} ms (median of "
            f"steps 2-{steps}), {DGCNN_BATCH / steady:.1f} clouds/s, first step "
            f"{first * 1e3:.1f} ms, max_memory_allocated {peak / 2 ** 30:.2f} GiB")
        if i == 0:
            out["dropout"] = launches
        if i < 2:   # dropout_patch_pointmae and dropout_global_p3: busy time
            profile_step(torch, one_more, card, top=12)
        del one_more
        torch.cuda.empty_cache()

    config = load_cfg(MASKFEAT_CFG)
    log(f"  {os.path.basename(MASKFEAT_CFG)} (MaskFeat_dgcnn), {MASKFEAT_STEPS} steps:")
    steady, first, launches, peak, one_more = run_steps(torch, config, raw, device,
                                                        MASKFEAT_STEPS, SEED + 65)
    if min(launches[k] for k in MASKFEAT_COUNTERS) == 0 or launches["knn"] != 5 * MASKFEAT_STEPS:
        fail(f"train: MaskFeat_dgcnn did not launch its kernels as expected: {launches}")
    log(f"  launches ({MASKFEAT_STEPS} steps): { {k: v for k, v in launches.items() if v} }")
    log(f"  [{card}] MaskFeat_dgcnn step {steady * 1e3:.2f} ms (median of steps "
        f"2-{MASKFEAT_STEPS}), {DGCNN_BATCH / steady:.1f} clouds/s, first step "
        f"{first * 1e3:.1f} ms, max_memory_allocated {peak / 2 ** 30:.2f} GiB")
    profile_step(torch, one_more, card, top=15)
    out["maskfeat"] = launches
    del one_more
    torch.cuda.empty_cache()
    return out


def phase_hybrid(torch, config, raw, corrupted, device, card):
    """edgeconv_knn: xla on the DGCNN step: the bf16 encoder's global feature
    with the hybrid kNN against the fused kernel's on the same weights and
    points (bit for bit: the kNN kernel and the fused selection share their
    arithmetic), then HYBRID_STEPS train steps. Returns their counters."""
    from point_dae_torch.engine.pretrain import init_model
    from point_dae_torch.utils import kernels

    hyb = copy.deepcopy(config)
    hyb["model"]["edgeconv_knn"] = "xla"
    fused = init_model(config, seed=SEED + 66, device=device).eval()
    hybrid = init_model(hyb, seed=SEED + 66, device=device).eval()
    before = dict(kernels.launches)
    with torch.no_grad():
        a = fused.dgcnn_encoder(corrupted)[0]
        b = hybrid.dgcnn_encoder(corrupted)[0]
    used = {k: kernels.launches[k] - before[k] for k in ("knn_aggregate_fwd", "knn",
                                                          "aggregate_from_idx")}
    same = torch.equal(a, b)
    log(f"  hybrid kNN vs fused kernel, bf16 encoder at batch {corrupted.shape[0]}: global "
        f"features bit for bit {same} (max gap {float((a - b).abs().max())}); launches {used}")
    if not same or used["knn"] != 4 or used["aggregate_from_idx"] != 4:
        fail(f"hybrid: the hybrid encoder differs from the fused one or missed its kernels")
    del fused, hybrid, a, b
    log(f"  edgeconv_knn xla, {HYBRID_STEPS} steps:")
    steady, _, launches, _, _ = run_steps(torch, hyb, raw, device, HYBRID_STEPS, SEED + 7)
    if launches["knn_aggregate_fwd"] or not launches["knn"] or not launches["aggregate_from_idx"]:
        fail(f"train: edgeconv_knn xla did not take the hybrid path: {launches}")
    log(f"  [{card}] DGCNN step with edgeconv_knn xla {steady * 1e3:.2f} ms "
        f"(step 2 of {HYBRID_STEPS}); launches { {k: v for k, v in launches.items() if v} }")
    return launches


def phase_mlp_wide_kernels(torch, device):
    """The memory keys' kernels: fused_mlp (the MLP of a block on a bf16 residual
    stream) at the flagship decoder's and encoder's row counts, R 16384 and
    8192 (C 384, H 1536), forward and backward against fused_mlp_plain; and
    gather_rows_wide at (16, 2048, 64) by 40960 rows (the partseg DGCNN edge
    gather's shape), bit for bit against its plain version and torch.gather,
    from int32 and int64 indices. Returns (records, gather_rows_wide launches
    of this phase)."""
    from point_dae_torch.ops import gather, mlp
    from point_dae_torch.utils import kernels

    records = {}
    g = torch.Generator(device=device).manual_seed(SEED + 90)
    C, H = 384, 1536
    bf = torch.bfloat16
    k1 = torch.randn((C, H), generator=g, device=device) / math.sqrt(C)
    b1 = 0.02 * torch.randn((H,), generator=g, device=device)
    k2 = torch.randn((H, C), generator=g, device=device) / math.sqrt(H)
    b2 = 0.02 * torch.randn((C,), generator=g, device=device)
    k1b, k2b = k1.to(bf).contiguous(), k2.to(bf).contiguous()
    for R in (BATCH * 64, BATCH * 32):
        x = torch.randn((R, C), generator=g, device=device).to(bf)   # LN2's bf16 output
        cot = torch.randn((R, C), generator=g, device=device)
        leaves = [t.clone().requires_grad_() for t in (x, k1, b1, k2, b2)]
        y_k = mlp.fused_mlp(*leaves)
        gk = torch.autograd.grad(y_k, leaves, cot)
        y_p = mlp.fused_mlp_plain(x, k1, b1, k2, b2)
        gp = mlp.mlp_bwd_plain(x, k1b, b1, k2b, cot, round_out=False)
        worst = {"y": rel_err(y_k, y_p)}
        abs_err = {"y": float((y_k - y_p).detach().abs().max())}
        for name, a, b in zip(MLP_GRADS, gk, gp):
            worst[name] = rel_err(a, b)
            abs_err[name] = float((a.float() - b.float()).abs().max())
        log(f"  fused_mlp at R {R} max error / max |plain| (gradients against mlp_bwd_plain, "
            "dx and weights before their bf16 rounding): "
            + " ".join(f"{k} {v:.2e}" for k, v in worst.items()))
        if worst["y"] > MLP_FWD_TOL:
            fail(f"fused_mlp disagrees with its plain version at R {R}: {worst}")
        if max(v for k, v in worst.items() if k != "y") > MLP_BWD_TOL:
            fail(f"fused_mlp backward disagrees with mlp_bwd_plain at R {R}: {worst}")
        del leaves, y_k, gk, y_p, gp
        fwd = mlp_report(torch, "mlp", "forward", lambda: mlp.mlp_fwd_kernel(x, k1b, b1, k2b, b2),
                         R, C, H, device, plain=lambda: mlp.fused_mlp_plain(x, k1, b1, k2, b2))
        fwd_ms, plain_fwd = fwd["ms"], fwd["plain_ms"]
        bwd_args = (x, k1b, b1, k2b, cot)
        bwd = mlp_report(torch, "mlp", "backward", lambda: mlp.mlp_bwd_kernel(*bwd_args),
                         R, C, H, device, plain=lambda: mlp.mlp_bwd_plain(*bwd_args))
        mm = 2 * R * C * H
        fwd_bytes = R * C * (2 + 4) + 2 * C * H * 2 + (H + C) * 4
        bwd_bytes = R * C * (2 + 4 + 2) + 4 * C * H * 2 + 2 * (H + C) * 4
        if R != BATCH * 64:
            log(f"  fused_mlp at R {R}: fwd {fwd_ms:.4f} ms (plain {plain_fwd:.4f}, bound "
                f"{bound_ms(fwd_bytes, 2 * mm, BF16_FLOPS)[0]:.4f}), bwd {bwd['ms']:.4f} ms "
                f"(plain {bwd['plain_ms']:.4f}, bound "
                f"{bound_ms(bwd_bytes, 5 * mm, BF16_FLOPS)[0]:.4f})")
            continue
        for name, ms, pms, nbytes, flops, err, line in (
                ("mlp_fwd", fwd_ms, plain_fwd, fwd_bytes, 2 * mm, abs_err["y"], "138"),
                ("mlp_bwd", bwd["ms"], bwd["plain_ms"], bwd_bytes, 5 * mm,
                 max(v for k, v in abs_err.items() if k != "y"), "158")):
            records[name] = dict(
                replaces=f"point_dae_tpu/ops/pallas_mlp.py:{line}",
                source="point_dae_torch/csrc/mlp.cu", max_abs_err=err, ms=ms,
                plain_ms=pms, library_ms=None, bound=bound_ms(nbytes, flops, BF16_FLOPS),
                note=f"R {R}, C {C}, H {H}; " + (bwd["note"] if name == "mlp_bwd" else fwd["note"]))
        del x, cot

    before = kernels.launches["gather_rows_wide"]
    B, N, Cw, Q = 16, 2048, 64, 40960
    xw = torch.randn((B, N, Cw), generator=g, device=device)
    idx = torch.randint(0, N, (B, Q), generator=g, device=device, dtype=torch.int32)
    idx_l = idx.long()
    idx64 = idx_l[..., None].expand(-1, -1, Cw)
    got = gather.gather_rows_wide(xw, idx)
    if not (torch.equal(got, gather.gather_rows_wide_plain(xw, idx))
            and torch.equal(got, torch.gather(xw, 1, idx64))
            and torch.equal(gather.gather_rows_wide(xw, idx_l), got)):
        fail("gather_rows_wide differs from its plain version or torch.gather")
    bad = idx_l.clone()
    bad[0, :3] = torch.tensor([-1, N, 2 ** 40], device=device)
    got_bad = gather.gather_rows_wide(xw, bad)
    if not (torch.equal(got_bad, gather.gather_rows_wide_plain(xw, bad))
            and not got_bad[0, :3].any()):
        fail("gather_rows_wide from an int64 index with rows out of range is wrong")
    xb = xw.to(bf)
    if not (torch.equal(gather.gather_rows_wide(xb, idx), gather.gather_rows_wide_plain(xb, idx))
            and torch.equal(gather.gather_rows_wide(xb, idx_l), gather.gather_rows_wide_plain(xb, idx))):
        fail("gather_rows_wide on bf16 rows differs from its plain version")
    log("  gather_rows_wide: bit for bit from int32 and int64 indices, f32 and bf16 rows, "
        "zero rows out of range")
    ms = cuda_ms(lambda: gather.gather_rows_wide(xw, idx), 50)
    ms64 = cuda_ms(lambda: gather.gather_rows_wide(xw, idx_l), 50)
    lib_ms = cuda_ms(lambda: torch.gather(xw, 1, idx64), 50)
    lib_cast_ms = cuda_ms(lambda: torch.gather(xw, 1, idx.long()[..., None].expand(-1, -1, Cw)), 50)
    bf_ms = cuda_ms(lambda: gather.gather_rows_wide(xb, idx), 50)
    dev, _ = device_ms(lambda: gather.gather_rows_wide(xw, idx), "gather_rows_wide")
    dev64, _ = device_ms(lambda: gather.gather_rows_wide(xw, idx_l),
                         "gather_rows_wide (int64 index)")
    lib_dev, _ = device_ms(lambda: torch.gather(xw, 1, idx64), "torch.gather", library=True)
    log(f"  gather_rows_wide ({B}, {N}, {Cw}) by {Q} rows: {ms:.4f} ms a call from the int32 "
        f"index (device {dev:.4f}), {ms64:.4f} from int64 (device {dev64:.4f}); torch.gather "
        f"from a ready int64 index {lib_ms:.4f} (device {ms_text(lib_dev)}), from the int32 index "
        f"(cast included) {lib_cast_ms:.4f}; bf16 rows {bf_ms:.4f}")
    records["gather_rows_wide"] = dict(
        replaces="point_dae_tpu/ops/pallas_scatter.py:101",
        source="point_dae_torch/csrc/gather.cu", max_abs_err=0.0, ms=ms,
        plain_ms=cuda_ms(lambda: gather.gather_rows_wide_plain(xw, idx), 50),
        library_ms=None if lib_dev is None else lib_ms,
        bound=bound_ms(xw.numel() * 4 + idx.numel() * 4 + got.numel() * 4, 0, F32_FLOPS),
        note=f"({B}, {N}, {Cw}) by {Q} rows, bit for bit; int64 index {ms64:.4f} ms; device "
             f"{dev:.4f} (torch.gather {ms_text(lib_dev)}); bf16 rows {bf_ms:.4f} ms")
    return records, kernels.launches["gather_rows_wide"] - before


WIDE_MLP_C = (512, 768, 1024)   # widths past the flagship's checked, H = 4 C
WIDE_MLP_CHECK_ROWS = 256
WIDE_MLP_TIME_ROWS = BATCH * 64  # the flagship decoder's row count


def phase_mlp_wide_c(torch, device, card):
    """The mlp_ln and mlp kernels at rows wider than 384, C 512, 768 and
    1024 (H 4 C), against their plain versions at R 256 with the card
    tests' tolerances (the output within MLP_FWD_TOL of the branch's largest
    value, every gradient within MLP_BWD_TOL of the plain twin's); then each
    direction's time at R 16384 beside its plain version and bound, the
    forward's device time by launch and its two products through
    torch.matmul (mlp_report)."""
    from point_dae_torch.ops import mlp

    g = torch.Generator(device=device).manual_seed(SEED + 95)
    bf = torch.bfloat16
    for C in WIDE_MLP_C:
        H = 4 * C

        def weights():
            return [torch.randn((C, H), generator=g, device=device) / math.sqrt(C),
                    0.02 * torch.randn((H,), generator=g, device=device),
                    torch.randn((H, C), generator=g, device=device) / math.sqrt(H),
                    0.02 * torch.randn((C,), generator=g, device=device)]

        def ln_args(R):
            return [torch.randn((R, C), generator=g, device=device),
                    1 + 0.1 * torch.randn((C,), generator=g, device=device),
                    0.05 * torch.randn((C,), generator=g, device=device)] + weights()

        R = WIDE_MLP_CHECK_ROWS
        sc = ((torch.rand((R,), generator=g, device=device) >= 0.1) / 0.9).float()
        cot = torch.randn((R, C), generator=g, device=device)
        la = ln_args(R)
        xb = torch.randn((R, C), generator=g, device=device).to(bf)
        ma = [xb] + weights()
        for name, args, kfn, pfn, kw, twin in (
                ("mlp_ln", la, mlp.fused_mlp_ln, mlp.fused_mlp_ln_plain, {"row_scale": sc},
                 lambda: mlp.mlp_ln_bwd_plain(la[0], la[1], la[2], la[3].to(bf), la[4],
                                              la[5].to(bf), sc, cot, round_out=False)),
                ("mlp", ma, mlp.fused_mlp, mlp.fused_mlp_plain, {},
                 lambda: mlp.mlp_bwd_plain(xb, ma[1].to(bf), ma[2], ma[3].to(bf), cot,
                                           round_out=False))):
            lk = [t.clone().requires_grad_() for t in args]
            yk, yp = kfn(*lk, **kw), pfn(*args, **kw)
            gk = torch.autograd.grad(yk, lk, cot)
            base = args[0] if name == "mlp_ln" else 0
            worst = {"y": rel_err(yk - base, yp - base)}
            worst.update({f"g{i}": rel_err(a, b) for i, (a, b) in enumerate(zip(gk, twin()))})
            log(f"  {name}, R {R}, C {C}, H {H}: max error / max |plain| "
                + " ".join(f"{k} {v:.2e}" for k, v in worst.items()))
            if worst["y"] > MLP_FWD_TOL or \
                    max(v for k, v in worst.items() if k != "y") > MLP_BWD_TOL:
                fail(f"{name} at C {C} disagrees with its plain version: {worst}")
            del lk, yk, yp, gk

        R = WIDE_MLP_TIME_ROWS
        xa = ln_args(R)
        scr = torch.ones((R,), device=device)
        cotr = torch.randn((R, C), generator=g, device=device)
        k1b, k2b = xa[3].to(bf).contiguous(), xa[5].to(bf).contiguous()
        xb = xa[0].to(bf)
        mm = 2 * R * C * H
        wbytes = 2 * C * H * 2
        lines = []
        for name, fwd, bwd, pfwd, pbwd, io in (
                ("mlp_ln",
                 lambda: mlp.mlp_ln_fwd_kernel(xa[0], xa[1], xa[2], k1b, xa[4], k2b, xa[6], scr),
                 lambda: mlp.mlp_ln_bwd_kernel(xa[0], xa[1], xa[2], k1b, xa[4], k2b, scr, cotr),
                 lambda: mlp.fused_mlp_ln_plain(*xa, row_scale=scr),
                 lambda: mlp.mlp_ln_bwd_plain(xa[0], xa[1], xa[2], k1b, xa[4], k2b, scr, cotr),
                 R * C * 4),
                ("mlp", lambda: mlp.mlp_fwd_kernel(xb, k1b, xa[4], k2b, xa[6]),
                 lambda: mlp.mlp_bwd_kernel(xb, k1b, xa[4], k2b, cotr),
                 lambda: mlp.fused_mlp_plain(xb, *xa[3:]),
                 lambda: mlp.mlp_bwd_plain(xb, k1b, xa[4], k2b, cotr), R * C * 2)):
            f_ms = mlp_report(torch, name, "forward", fwd, R, C, H, device, iters=5)["ms"]
            b_ms, p_ms, pb_ms = cuda_ms(bwd, 5), cuda_ms(pfwd, 3), cuda_ms(pbwd, 2)
            bf_ = bound_ms(io + R * C * 4 + wbytes, 2 * mm, BF16_FLOPS)
            bb_ = bound_ms(2 * io + R * C * 4 + 2 * wbytes, 5 * mm, BF16_FLOPS)
            lines.append(f"{name} fwd {f_ms:.4f} ms (plain {p_ms:.4f}, bound {bf_[0]:.4f} by "
                         f"{bf_[1]}), bwd {b_ms:.4f} ms (plain {pb_ms:.4f}, bound {bb_[0]:.4f} "
                         f"by {bb_[1]}; {5 * mm / b_ms / 1e9:.1f} TFLOP/s)")
        log(f"  [{card}] wide rows at R {R}, C {C}, H {H}: " + "; ".join(lines))
        del xa, xb, k1b, k2b, cotr
        torch.cuda.empty_cache()


def grads_of(torch, model, run):
    """Loss, every parameter's gradient and every running statistic of one
    train-mode forward (``run(model)`` returns the losses) and backward."""
    losses = run(model)
    sum(losses).backward()
    return ([v.detach() for v in losses],
            {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
            {n: b for n, b in model.named_buffers() if "running" in n})


def same_bits(torch, a, b) -> list:
    """Names where two grads_of results differ (losses included)."""
    (la, ga, sa), (lb, gb, sb) = a, b
    bad = [f"loss{i}" for i, (x, y) in enumerate(zip(la, lb)) if not torch.equal(x, y)]
    bad += [k for k in ga if k not in gb or not torch.equal(ga[k], gb[k])]
    return bad + [k for k in sa if not torch.equal(sa[k], sb[k])]


def phase_memory_check(torch, config, dconfig, raw, corrupted_d, clean_d, device):
    """The memory keys on the card, against the CPU and against themselves:

    - the flagship under residual_dtype bf16 at MEM_CHECK_BATCH (the
      smallest batch at which the fused_mlp gate opens in both stacks:
      8 x 32 and 8 x 64 rows are multiples of 256) on the card (kernels)
      against the CPU (plain paths: the bf16 chain, bias and GELU rounded to
      bf16, where the kernel keeps the hidden in f32), with the same weights
      and draws, both losses within 2% (the bound of the default check);
      the card run again with the block's plain chain instead of the mlp
      kernels shows how much of the gap the kernels' rounding makes. It
      fails unless mlp_fwd launched 16 times and mlp_ln_fwd not at all;
    - remat + remat_fold against neither, on an f32 and on a bf16 residual
      stream, and the DGCNN encoder's remat against none, each a train-mode
      forward and backward at batch 8 with the same weights and draws: the
      losses, every gradient and every running statistic bit for bit. The
      kernels sum in a fixed order; PyTorch's scatter-adds (the backward of
      torch.gather) run in their deterministic mode for this comparison.
    """
    from point_dae_torch.engine.pretrain import device_pipeline, init_model
    from point_dae_torch.models import layers
    from point_dae_torch.utils import kernels

    res = with_keys(config, RESIDUAL_BF16)
    cpu_model = init_model(res, seed=SEED + 40, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED + 41)
    _, clean = device_pipeline(raw[:MEM_CHECK_BATCH], d["aug_type"], d["corrupt_type"],
                               d["npoints"], generator=g, device=device)
    draws = gpu_model.sample_draws(MEM_CHECK_BATCH, g, device)
    before = dict(kernels.launches)
    route = layers.mlp_route
    with torch.no_grad():
        lg = [float(v) for v in gpu_model(clean, clean, draws=copy.deepcopy(draws))]
        used = {k: kernels.launches[k] - before[k] for k in ("mlp_fwd", "mlp_ln_fwd")}
        layers.mlp_route = lambda *a: "plain" if route(*a) == "fused" else route(*a)
        try:
            lp = [float(v) for v in gpu_model(clean, clean, draws=copy.deepcopy(draws))]
        finally:
            layers.mlp_route = route
        clean_cpu = clean.cpu()
        lc = [float(v) for v in cpu_model(clean_cpu, clean_cpu, draws=on_device(draws, "cpu"))]
    gap = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    log(f"  residual_dtype bf16, batch {MEM_CHECK_BATCH}: card (mlp kernels) {lg}, card with "
        f"the plain chain {lp}, cpu (plain) {lc}; gap card-cpu {gap(lg, lc):.2e}, of which "
        f"the mlp kernels' rounding (card vs card plain chain) {gap(lg, lp):.2e} and the rest "
        f"(card plain chain vs cpu) {gap(lp, lc):.2e}; launches {used}")
    if not all(math.isfinite(v) for v in lg + lc):
        fail("check: non-finite loss under residual_dtype bf16")
    if gap(lg, lc) > 2e-2:                  # bf16 products: 2% of the loss
        fail(f"check: residual_dtype bf16 card losses {lg} disagree with the CPU's {lc}")
    if used["mlp_fwd"] != 16 or used["mlp_ln_fwd"]:
        fail(f"check: residual_dtype bf16 did not take the mlp kernels: {used}")
    del cpu_model, gpu_model

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, base in (("f32 residual", {}), ("bf16 residual", RESIDUAL_BF16)):
            keys = dict(base, remat=True, remat_fold="True")
            runs, launch = [], []
            for cfg in (with_keys(config, keys), with_keys(config, base)):
                model = init_model(cfg, seed=SEED + 42, device=device)
                before = dict(kernels.launches)
                runs.append(grads_of(torch, model, lambda m: m(
                    clean, clean, draws=copy.deepcopy(draws))))
                launch.append({k: kernels.launches[k] - before[k] for k in (
                    "mlp_fwd", "mlp_ln_fwd", "attention_fwd", "folding_fwd") if
                    kernels.launches[k] - before[k]})
                del model
            bad = same_bits(torch, *runs)
            log(f"  remat + remat_fold, {name}, batch {MEM_CHECK_BATCH}: losses "
                f"{[float(v) for v in runs[0][0]]} and {[float(v) for v in runs[1][0]]}, "
                f"{len(runs[0][1])} gradients and {len(runs[0][2])} running statistics, "
                f"{'all bit for bit' if not bad else f'differing: {bad[:8]}'}; "
                f"forward launches with {launch[0]}, without {launch[1]}")
            if bad:
                fail(f"check: remat + remat_fold changed {bad[:8]} ({name})")
        runs = []
        for remat in (True, False):
            cfg = copy.deepcopy(dconfig)
            cfg["model"]["remat"] = remat
            model = init_model(cfg, seed=SEED + 43, device=device)
            before = kernels.launches["knn_aggregate_fwd"]
            runs.append(grads_of(torch, model, lambda m: m(
                corrupted_d[:MEM_CHECK_BATCH], clean_d[:MEM_CHECK_BATCH])))
            log(f"  DGCNN remat {remat}: knn_aggregate_fwd launches "
                f"{kernels.launches['knn_aggregate_fwd'] - before}")
            del model
        bad = same_bits(torch, *runs)
        log(f"  DGCNN remat, batch {MEM_CHECK_BATCH}: loss {float(runs[0][0][0])} and "
            f"{float(runs[1][0][0])}, {len(runs[0][1])} gradients and {len(runs[0][2])} running "
            f"statistics, {'all bit for bit' if not bad else f'differing: {bad[:8]}'}")
        if bad:
            fail(f"check: the DGCNN encoder's remat changed {bad[:8]}")
    finally:
        torch.use_deterministic_algorithms(False)


def phase_memory_train(torch, config, raw, device, card, default):
    """TRAIN_STEPS flagship steps under residual_dtype bf16 at bs 256 (16
    mlp_fwd and mlp_bwd launches a step, no mlp_ln), then MEM_STEPS of each
    of MEM_VARIANTS, each beside the default run's step time and peak
    memory (``default``: steady seconds, peak bytes), and one profiled step
    of each (device busy against wall). Returns the residual run's
    launches."""
    steady_d, peak_d = default

    def line(name, steady, peak, steps):
        log(f"  [{card}] {name}: {steady * 1e3:.2f} ms a step (median of steps 2-{steps}), "
            f"{BATCH / steady:.1f} clouds/s, max_memory_allocated {peak / 2 ** 30:.2f} GiB; "
            f"default {steady_d * 1e3:.2f} ms, {BATCH / steady_d:.1f} clouds/s, "
            f"{peak_d / 2 ** 30:.2f} GiB")

    log(f"  residual_dtype bf16, {TRAIN_STEPS} steps:")
    steady, _, launches, peak, one_more = run_steps(torch, with_keys(config, RESIDUAL_BF16),
                                                    raw, device, TRAIN_STEPS, SEED)
    want = 16 * TRAIN_STEPS
    if (launches["mlp_fwd"], launches["mlp_bwd"]) != (want, want) or \
            launches["mlp_ln_fwd"] or launches["mlp_ln_bwd"]:
        fail(f"train: residual_dtype bf16 did not launch mlp 16 times a step: {launches}")
    log(f"  launches ({TRAIN_STEPS} steps): "
        f"{ {k: v for k, v in launches.items() if v and k in FLAGSHIP_COUNTERS + ('mlp_fwd', 'mlp_bwd')} }")
    line("residual_dtype bf16", steady, peak, TRAIN_STEPS)
    profile_step(torch, one_more, card, top=0)
    del one_more
    torch.cuda.empty_cache()
    for name, keys in MEM_VARIANTS:
        log(f"  {name}, {MEM_STEPS} steps:")
        steady_v, _, lv, peak_v, one_more = run_steps(torch, with_keys(config, keys), raw,
                                                      device, MEM_STEPS, SEED)
        log(f"  launches ({MEM_STEPS} steps): "
            f"{ {k: v for k, v in lv.items() if v and k in FLAGSHIP_COUNTERS + ('mlp_fwd', 'mlp_bwd')} }")
        line(name, steady_v, peak_v, MEM_STEPS)
        profile_step(torch, one_more, card, top=0)
        del one_more
        torch.cuda.empty_cache()
    return launches


def phase_dgcnn_remat(torch, config, raw, device, card, default):
    """MEM_STEPS DGCNN steps with the encoder's remat, beside the default
    run's step time and peak memory."""
    steady_d, peak_d = default
    cfg = copy.deepcopy(config)
    cfg["model"]["remat"] = True
    log(f"  DGCNN remat, {MEM_STEPS} steps:")
    steady, _, launches, peak, one_more = run_steps(torch, cfg, raw, device, MEM_STEPS,
                                                    SEED + 7)
    if not launches["knn_aggregate_fwd"]:
        fail(f"train: DGCNN remat launched no EdgeConv kernel: {launches}")
    log(f"  launches ({MEM_STEPS} steps): { {k: v for k, v in launches.items() if v} }")
    log(f"  [{card}] DGCNN remat: {steady * 1e3:.2f} ms a step (step 2 of {MEM_STEPS}), "
        f"{DGCNN_BATCH / steady:.1f} clouds/s, max_memory_allocated {peak / 2 ** 30:.2f} GiB; "
        f"default {steady_d * 1e3:.2f} ms, {DGCNN_BATCH / steady_d:.1f} clouds/s, "
        f"{peak_d / 2 ** 30:.2f} GiB")
    profile_step(torch, one_more, card, top=0)


# -- the cloud and patch corruption families, the unmasked flagship
CLOUD_CHECK = (            # (case, corrupt_type), each at the DGCNN pipeline's (128, 8192)
    *((t, (t,)) for t in ("affine_r3", "affine_r5", "affine_r3_v2", "affine_r5_v2",
                          "translate", "translate_tiny", "translate_middle",
                          "translate_too_large", "scale_nonorm", "scale_nonorm_1p5",
                          "scale_nonorm_4", "scale_nonorm_10", "rotate", "rotate_level0",
                          "rotate_level1", "rotate_level2", "rotate_level3", "rotate_level4",
                          "rotate_z", "reflection", "shear", "shear_p1", "shear_p3",
                          "shear_p5", "shear_p8", "shear_1p", "shear_2p", "shear_small",
                          "scale_single", "jitter", "jitter_p01", "jitter_p03", "jitter_p05",
                          "jitter_p1", "dropout_local", "dropout_local_c1d1",
                          "dropout_local_c5d3", "dropout_local_c8d9", "add_global",
                          "add_local", "random_add", "nonuniform_density")),
    ("dropout_local + scale", ("dropout_local", "scale")),
    ("random_add + affine_r3", ("random_add", "affine_r3")),
    ("affine_r5_v2 + dropout_local_c5d3", ("affine_r5_v2", "dropout_local_c5d3")))
AUG_CHECK = ("norm", "translate", "scale", "rotate_z", "rotate")
PATCH_CHECK_SHAPE = (256, 64, 32)      # the bf16 flagship's batch, G, S
CORRUPT_STEPS = 5
CORRUPT_CFGS = (           # (shipped config, kernels its steps must launch), bs 128
    ("cfgs/generated/pretrain_PointCAE_random_add_affine_r3.yaml", DGCNN_COUNTERS),
    ("cfgs/generated/pretrain_PointCAE_affine_r5_v2_dropout_local_c5d3.yaml", DGCNN_COUNTERS),
    ("cfgs/generated/pretrain_PointCAE_transformer_add_local.yaml",
     ("patchify", "gather_rows_small_c", "nn_half_small")))
UNMASKED_TYPES = ["add_local"]         # the shipped unmasked configs' model corrupt_type
UNMASKED_CHECK_BATCH = 64  # the patch chamfer's gate (4096 pairs) opens at 64 clouds


def f32_ulp(torch, x):
    """The spacing of float32 at |x|."""
    x = x.abs().float()
    return torch.nextafter(x, torch.full_like(x, float("inf"))) - x


def phase_corruptions_check(torch, raw, device):
    """Every cloud family (each alone, three pairs of the shipped configs'),
    the augmentations and every patch family on the card against the CPU
    with the same draws, sampled on the card: the cloud families at the
    DGCNN pipeline's shape, (128, 8192) normalised clouds (normalised once on
    the CPU, so both sides start from the same bits) to the buffer of
    corruption_capacity rows and its mask, then resampled to 1024 from the
    same uniforms; the patch families at the bf16 flagship's (256, 64, 32, 3).
    Points within 1e-5 (relative and absolute, the CPU tests' tolerance
    against the JAX package); masks equal, except that a flip of
    nonuniform_density or scan, whose masks are strict compares of a
    distance with a uniform, is allowed where the CPU's distance lies within
    1 ulp of the uniform (such flips are counted and printed); the
    resampled points within 1e-5 where no mask flipped."""
    from point_dae_torch.data import corruptions as tc
    from point_dae_torch.data import corruptions_patch as tcp
    from point_dae_torch.ops.geometry import resample_batch

    B, n = raw.shape[:2]
    g = torch.Generator(device=device).manual_seed(SEED + 70)
    base_cpu = tc.pc_normalize(raw[..., :3].float().cpu())
    base = base_cpu.to(device)
    t0 = time.perf_counter()
    close = lambda a, b: torch.allclose(a.cpu(), b, rtol=1e-5, atol=1e-5)
    gap = lambda a, b: float((a.cpu() - b).abs().max())

    d = tc.sample_augment_draws(AUG_CHECK, B, g, device)
    got = tc.augment_batch(base, AUG_CHECK, d)
    want = tc.augment_batch(base_cpu, AUG_CHECK, on_device(d, "cpu"))
    log(f"  augment {'+'.join(AUG_CHECK)} ({B}, {n}): max |card - cpu| {gap(got, want):.2e}")
    if not close(got, want):
        fail(f"corruptions: the augmentations on the card are off the CPU's by {gap(got, want)}")

    flipped = {}
    for name, types in CLOUD_CHECK:
        draws = tc.sample_corrupt_draws(types, B, n, g, device)
        pts, mask = tc.corrupt_batch(base, types, draws)
        cd = on_device(draws, "cpu")
        cpts, cmask = tc.corrupt_batch(base_cpu, types, cd)
        flips = 0 if cmask is None else int((mask.cpu() != cmask).sum())
        if flips and types == ("nonuniform_density",):
            # the compare: |p - v| / 2 * gate < r, at the flipped rows
            dens, level = cd.ops[0], cd.levels[:, 0]
            v = dens.view / tc._sqnorm3(dens.view).sqrt().clamp_min(1e-12)[:, None]
            dist = tc._sqnorm3(base_cpu - v[:, None]).sqrt() / 2.0 * (level / 4.0 + 0.1)[:, None]
            at = mask.cpu() != cmask
            if not ((dist[at] - dens.r[at]).abs() <= f32_ulp(torch, dens.r[at])).all():
                fail(f"corruptions: {name} flipped {flips} rows away from a tie")
            flipped[name] = flips
        elif flips:
            fail(f"corruptions: {name}'s mask on the card differs from the CPU's in {flips} rows")
        cap = tc.corruption_capacity(n, types)
        u = torch.rand((B, 1024), generator=g, device=device)
        draw = u if mask is not None else (u * cap).long()
        rg = resample_batch(pts, mask, 1024, draws=draw)
        rc = resample_batch(cpts, cmask, 1024, draws=draw.cpu())
        valid = "" if cmask is None else f", valid rows {int(cmask.sum(1).min())}-{int(cmask.sum(1).max())} of {cap}"
        log(f"  {name}: ({B}, {n}) -> ({B}, {cap}){valid}, max |card - cpu| {gap(pts, cpts):.2e} "
            f"(largest |x| {float(cpts.abs().max()):.2f}), mask flips {flips}, resampled to "
            f"1024 max |card - cpu| {gap(rg, rc):.2e}")
        if pts.shape != cpts.shape or not close(pts, cpts):
            fail(f"corruptions: {name} on the card is off the CPU's by {gap(pts, cpts)}")
        if not flips and not close(rg, rc):
            fail(f"corruptions: {name}'s resample on the card is off the CPU's by {gap(rg, rc)}")

    Bp, G, S = PATCH_CHECK_SHAPE
    pg = torch.Generator().manual_seed(SEED + 71)
    center_cpu = torch.randn((Bp, G, 3), generator=pg)
    neigh_cpu = center_cpu[:, :, None] + 0.1 * torch.randn((Bp, G, S, 3), generator=pg)
    neigh, center = neigh_cpu.to(device), center_cpu.to(device)
    for t in sorted(tcp.PATCH_SUPPORTED):
        draws = tcp.sample_patch_draws((t,), Bp, G, S, g, device)
        gn, gc = tcp.corrupt_patches(neigh, center, (t,), draws)
        cn, cc = tcp.corrupt_patches(neigh_cpu, center_cpu, (t,), on_device(draws, "cpu"))
        flips = 0
        if t == "scan":
            sd = on_device(draws[0], "cpu")
            keep_g, keep_c = (gn.cpu() == neigh_cpu).all(-1), (cn == neigh_cpu).all(-1)
            at = keep_g != keep_c
            flips = int(at.sum())
            v = sd.view / tc._sqnorm3(sd.view).sqrt().clamp_min(1e-12)
            dist = tc._sqnorm3(neigh_cpu - v).sqrt() / 2.0
            if flips and not ((dist[at] - sd.r[at]).abs() <= f32_ulp(torch, sd.r[at])).all():
                fail(f"corruptions: patch scan flipped {flips} points away from a tie")
            if flips:
                flipped[f"patch {t}"] = flips
            gn, cn = gn.cpu()[~at], cn[~at]
        log(f"  patch {t} {tuple(neigh.shape)}: max |card - cpu| patches {gap(gn, cn):.2e}, "
            f"centres {gap(gc, cc):.2e}, flips {flips}")
        if not (close(gn, cn) and close(gc, cc)):
            fail(f"corruptions: patch {t} on the card is off the CPU's by {gap(gn, cn)}")
    log(f"  corruption families checked in {time.perf_counter() - t0:.1f} s; mask flips "
        f"within 1 ulp of their compare: {flipped or 'none'}")


def corrupt_watch(shapes):
    """A ``run_steps`` watch that records, on the flagship model, the
    encoder's attention (B, T), the blocks' MLP rows, the folding head's
    tokens and the patch chamfer's pairs."""
    def watch(model):
        def rec(key):
            return lambda mod, args: shapes.setdefault(key, set()).add(tuple(args[0].shape[:2]))

        for blk in model.MAE_encoder.blocks.blocks:
            blk.attn.register_forward_pre_hook(rec("encoder attention (B, T)"))
        for blk in model.MAE_decoder.blocks:
            blk.register_forward_pre_hook(rec("decoder block (B, T)"))
        fold, local = model._fold, model._local_recon_inputs

        def fold_rec(x):
            shapes.setdefault("folding tokens", set()).add(x.shape[0] * x.shape[1])
            return fold(x)

        def local_rec(*a):
            out = local(*a)
            shapes.setdefault("patch chamfer pairs", set()).add(out[1].shape[0])
            return out

        model._fold, model._local_recon_inputs = fold_rec, local_rec
    return watch


def unmasked_check(torch, config, raw, device, tol, what):
    """One train-mode forward of the unmasked flagship at
    UNMASKED_CHECK_BATCH on the card against the CPU, same weights and
    draws: both losses within ``tol`` relative. Returns the card's launches."""
    from point_dae_torch.engine.pretrain import device_pipeline, init_model
    from point_dae_torch.utils import kernels

    cpu_model = init_model(config, seed=SEED + 72, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED + 73)
    _, clean = device_pipeline(raw[:UNMASKED_CHECK_BATCH], d["aug_type"], d["corrupt_type"],
                               d["npoints"], generator=g, device=device)
    draws = gpu_model.sample_draws(UNMASKED_CHECK_BATCH, g, device)
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    with torch.no_grad():
        lg = [float(v) for v in gpu_model(clean, clean, draws=draws)]
        used = {k: kernels.launches[k] - before[k] for k in kernels.launches
                if kernels.launches[k] != before[k]}
        cln = clean.cpu()
        lc = [float(v) for v in cpu_model(cln, cln, draws=on_device(draws, "cpu"))]
    log(f"  {what}, batch {UNMASKED_CHECK_BATCH}: card loss_xyz {lg[0]:.6f} loss_global "
        f"{lg[1]:.6f}; cpu ({time.perf_counter() - t0:.1f} s) {lc[0]:.6f} {lc[1]:.6f}; "
        f"launches {used}")
    if not all(math.isfinite(v) for v in lg + lc):
        fail(f"corrupt_train: non-finite loss in the {what} check")
    if any(abs(a_ - b_) > tol * abs(b_) for a_, b_ in zip(lg, lc)):
        fail(f"corrupt_train: {what}: card losses {lg} off the CPU's {lc} beyond {tol}")
    return used


def dgcnn_corrupt_check(torch, config, raw, device):
    """A DGCNN corruption config (f32) at DGCNN_CHECK_BATCH on the corrupted
    clouds of the card's pipeline: the encoder's global feature on the card
    (the fused kernel) against the CPU through the kernel's plain version
    within 1e-3 (relative and absolute) and the training loss within 1e-3
    relative, the tolerances of phase_dropout_maskfeat_check. The added
    blobs' points sit close, so a neighbour at a near tie can differ from
    the reference EdgeConv's (its gap is printed, not held to)."""
    from point_dae_torch.engine.pretrain import device_pipeline, init_model

    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED + 74)
    cor, cln = device_pipeline(raw[:DGCNN_CHECK_BATCH], d["aug_type"], d["corrupt_type"],
                               d["npoints"], generator=g, device=device)
    cpu_model = init_model(config, seed=SEED + 75, device="cpu").train()
    gpu_model = copy.deepcopy(cpu_model).to(device).train()
    cor_c, cln_c = cor.cpu(), cln.cpu()
    with torch.no_grad():
        fg = gpu_model.dgcnn_encoder(cor)[0].cpu()
        fc = dgcnn_feature_plain(torch, cpu_model.dgcnn_encoder, cor_c[..., :3])
        fr = cpu_model.dgcnn_encoder(cor_c)[0]
        lg = float(gpu_model(cor, cln)[0])
        lc = float(check_fused_plain_loss(torch, cpu_model, cor_c, cln_c, []))
    err = float((fg - fc).abs().max())
    log(f"  DGCNN {'+'.join(d['corrupt_type'])}, batch {DGCNN_CHECK_BATCH}: global feature "
        f"max |card - cpu (the kernel's plain version)| {err:.2e}, against the reference "
        f"EdgeConv {float((fg - fr).abs().max()):.2e}; loss card {lg:.6f} cpu {lc:.6f}")
    if not torch.allclose(fg, fc, rtol=1e-3, atol=1e-3):
        fail(f"corrupt_train: DGCNN features on the card off the CPU's by {err}")
    if not (math.isfinite(lg) and abs(lg - lc) <= 1e-3 * abs(lc)):
        fail(f"corrupt_train: DGCNN loss on the card {lg} off the CPU's {lc}")


def phase_corrupt_train(torch, raw_d, device, card):
    """5 steps each of two shipped DGCNN corruption configs and the shipped
    unmasked flagship config (f32, bs 128, from the (128, 8192, 6) clouds),
    then of FLAGSHIP_CONFIG with model corrupt_type ['add_local'] (bf16,
    bs 256, from (256, 8192, 6) clouds): step time, peak memory and a
    profiled step's busy time each, and the launches of each window. The
    bf16 unmasked flagship must launch attention forward and backward 16
    times a step with T 64 in the encoder, mlp_ln forward and backward 16
    times a step at R 16384, folding over 16384 tokens and the patch chamfer
    over 16384 pairs; the DGCNN steps knn_aggregate and the tiled chamfer.
    Before the steps, each model at a small batch on the card against the
    CPU (unmasked_check, dgcnn_corrupt_check)."""
    records = {}
    for path, want in CORRUPT_CFGS:
        config = load_cfg(path)
        name = os.path.basename(path)
        if "transformer" in name:
            unmasked_check(torch, config, raw_d, device, 1e-3, f"{name} (f32)")
        else:
            dgcnn_corrupt_check(torch, config, raw_d, device)
        log(f"  {name}, {CORRUPT_STEPS} steps:")
        steady, first, launches, peak, one_more = run_steps(torch, config, raw_d, device,
                                                            CORRUPT_STEPS, SEED + 76)
        if min(launches[k] for k in want) == 0:
            fail(f"corrupt_train: {name} did not launch every kernel of its path: {launches}")
        if "nn_half_small" in want and launches["nn_half_small"] != CORRUPT_STEPS:
            fail(f"corrupt_train: {name}'s patch chamfer did not launch once a step: {launches}")
        log(f"  launches ({CORRUPT_STEPS} steps): { {k: v for k, v in launches.items() if v} }")
        busy, _ = profile_step(torch, one_more, card, top=10)
        records[name] = (steady, peak, busy)
        log(f"  [{card}] {name} step {steady * 1e3:.2f} ms (median of steps 2-{CORRUPT_STEPS}), "
            f"{config['total_bs'] / steady:.1f} clouds/s, first step {first * 1e3:.1f} ms, "
            f"busy {busy / 1e3:.2f} ms, max_memory_allocated {peak / 2 ** 30:.2f} GiB")
        del one_more
        torch.cuda.empty_cache()

    config = copy.deepcopy(FLAGSHIP_CONFIG)
    config["model"]["corrupt_type"] = list(UNMASKED_TYPES)
    from point_dae_torch.utils.config import ConfigDict

    config = ConfigDict(config)
    g = torch.Generator(device=device).manual_seed(SEED + 77)
    raw = torch.randn((BATCH, NRAW, 6), generator=g, device=device)
    used = unmasked_check(torch, config, raw, device, 2e-2, "FLAGSHIP_CONFIG ['add_local'] (bf16)")
    if min(used.get(k, 0) for k in ("patchify", "nn_half_small", "mlp_ln_fwd", "folding_fwd",
                                    "attention_fwd")) == 0:
        fail(f"corrupt_train: a kernel gate of the unmasked flagship stayed closed: {used}")
    log(f"  FLAGSHIP_CONFIG with model corrupt_type {UNMASKED_TYPES} (unmasked, bf16, bs "
        f"{BATCH}), {CORRUPT_STEPS} steps:")
    shapes = {}
    steady, first, launches, peak, one_more = run_steps(
        torch, config, raw, device, CORRUPT_STEPS, SEED + 78, watch=corrupt_watch(shapes))
    log(f"  launches ({CORRUPT_STEPS} steps): { {k: v for k, v in launches.items() if v} }; "
        f"shapes {shapes}")
    per_step = 16 * CORRUPT_STEPS
    tokens = BATCH * config["model"]["num_group"]
    if min(launches[k] for k in FLAGSHIP_COUNTERS) == 0:
        fail(f"corrupt_train: the unmasked flagship missed a kernel: {launches}")
    if any(launches[k] != per_step for k in ("attention_fwd", "attention_bwd", "mlp_ln_fwd",
                                               "mlp_ln_bwd")):
        fail(f"corrupt_train: attention and mlp_ln did not launch 16 times a step each: "
             f"{launches}")
    if launches["nn_half_small"] != CORRUPT_STEPS or launches["folding_fwd"] < CORRUPT_STEPS:
        fail(f"corrupt_train: the folding head or the patch chamfer missed a step: {launches}")
    if (shapes.get("encoder attention (B, T)") != {(BATCH, 64)}
            or shapes.get("decoder block (B, T)") != {(BATCH, 64)}
            or shapes.get("folding tokens") != {tokens}
            or shapes.get("patch chamfer pairs") != {tokens}):
        fail(f"corrupt_train: the unmasked flagship ran at other shapes: {shapes}")
    busy, _ = profile_step(torch, one_more, card,
                           expect=("attention_fwd", "mlp_fwd_ln_rows", "fold_bwd_rows",
                                   "nn_half_small_kernel"))
    records["FLAGSHIP_CONFIG add_local"] = (steady, peak, busy)
    log(f"  [{card}] unmasked flagship (bf16, bs {BATCH}) step {steady * 1e3:.2f} ms (median of "
        f"steps 2-{CORRUPT_STEPS}), {BATCH / steady:.1f} clouds/s, first step "
        f"{first * 1e3:.1f} ms, busy {busy / 1e3:.2f} ms, max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB; attention {launches['attention_fwd'] // CORRUPT_STEPS} "
        f"forward and {launches['attention_bwd'] // CORRUPT_STEPS} backward launches a step "
        f"at T 64, mlp_ln {launches['mlp_ln_fwd'] // CORRUPT_STEPS} + "
        f"{launches['mlp_ln_bwd'] // CORRUPT_STEPS} a step at R {tokens}, folding over "
        f"{tokens} tokens, patch chamfer over {tokens} pairs")
    del one_more, raw
    torch.cuda.empty_cache()
    for name, (st, pk, bz) in records.items():
        log(f"  [{card}] corruption configs: {name}: {st * 1e3:.2f} ms a step, busy "
            f"{bz / 1e3:.2f} ms, peak {pk / 2 ** 30:.2f} GiB")


# -- the MaskSurf family and the dVAE tokenizer: five configurations at full
# width, bs 128, from (128, 8192, 6) clouds with unit normals
MASKSURF_BATCH, MASKSURF_STEPS = 128, 5
MASKSURF_V2_CFG = "cfgs/generated/pretrain_MaskSurf_v2.yaml"
RUN_DVAE_CFG = "cfgs/pretrain_synthetic_dvae.yaml"
RUN_TOKENDIS_CFG = "cfgs/pretrain_synthetic_masksurf_tokendis.yaml"
DVAE_DIMS = ("num_tokens", "encoder_dims", "tokens_dims", "decoder_dims")
MASKSURF_KERNELS = ("patchify", "gather_rows_small_c", "nn_half_small", "mlp_ln_fwd",
                    "mlp_ln_bwd", "attention_fwd", "attention_bwd")
_SURF = {"patchify": 1, "gather_rows_small_c": 2, "nn_half_small": 1}
_DECODER = {"mlp_ln_fwd": 4, "mlp_ln_bwd": 4, "attention_fwd": 4, "attention_bwd": 4}
# (what, config, transformer_config keys (None: Point_dVAE at its defaults),
# launches a step of each kernel of MASKSURF_KERNELS (0 where not named),
# card-against-CPU tolerance on each loss, relative: kNN near-ties move
# patches in the masked transformers, as in the flagship)
MASKSURF_RUNS = (
    ("MaskSurf_v2 (f32, as shipped)", MASKSURF_V2_CFG, {}, _SURF, 2e-2),
    ("MaskSurf_v2 (bf16)", MASKSURF_V2_CFG, {"dtype": "bf16"}, dict(_SURF, **_DECODER), 2e-2),
    ("MaskSurf", "cfgs/pretrain_MaskSurf.yaml", {}, _SURF, 2e-2),
    ("MaskSurf_v2_token_dis", "cfgs/generated/pretrain_MaskSurf_dvae_token.yaml", {},
     {"patchify": 1, "gather_rows_small_c": 1}, 2e-2),
    ("Point_dVAE (8192 tokens, 256 wide)", RUN_DVAE_CFG, None,
     {"patchify": 1, "gather_rows_small_c": 1, "nn_half_small": 2}, 1e-3))


def masksurf_config(path, keys):
    """A MaskSurf run's config: the shipped one with ``keys`` written into
    its transformer_config, or (keys None) the synthetic dVAE recipe with
    the tokenizer at its defaults (the dims keys dropped) at bs 128."""
    from point_dae_torch.utils.config import ConfigDict

    config = copy.deepcopy(load_cfg(path))
    if keys is None:
        for k in DVAE_DIMS:
            config["model"].pop(k)
        config["total_bs"] = MASKSURF_BATCH
    else:
        config["model"]["transformer_config"].update(keys)
    return ConfigDict(config)


def check_patchify(torch, pts, G, S, what):
    """The patchify kernel against its plain version: fps_idx bit for bit,
    kNN rows equal but at genuine near-ties (the selected distances within
    1e-4, more than 99.99% of the indices equal). Returns (fps_idx,
    knn_idx, the share of equal indices, the largest gap of the selected
    distances)."""
    from point_dae_torch.ops import patchify

    fk, kk = patchify.fused_patchify(pts, G, S)
    fp, kp = patchify.fused_patchify_plain(pts, G, S)
    torch.cuda.synchronize()
    if not torch.equal(fk, fp):
        fail(f"{what}: fps_idx differs from the plain version")
    center = pts.gather(1, fk.long()[..., None].expand(-1, -1, 3))
    d_all = ((pts[:, None] - center[:, :, None]) ** 2).sum(-1)     # (B, G, N)
    dk, dp = d_all.gather(-1, kk.long()), d_all.gather(-1, kp.long())
    match = float((kk == kp).float().mean())
    if not (torch.allclose(dk, dp, rtol=1e-4, atol=1e-4) and match > 0.9999):
        fail(f"{what}: knn disagrees beyond near-ties (idx match {match})")
    return fk, kk, match, float((dk - dp).abs().max())


def masksurf_kernels(torch, raw, device):
    """Each kernel of the MaskSurf and dVAE paths against its plain version
    at the paths' shapes, each behind its gate: patchify at (128, 1024) and
    at the Objaverse configs' (128, 8192), G 64, S 32; the small-C gather
    by 2048 rows a cloud from the strided xyz and normal views (C 3) and
    the curve variants' attributes (C 5), bit for bit; both directions of
    the patch chamfer over 4864 packed pairs of 32 and 32 points (the
    masked patches) and the dVAE's 8192 of 32 and 32 and of 8 and 32, bit
    for bit; attention at the decoder's (128, 64, 6, 64) within 2e-2 of the
    plain version's largest value. mlp_ln at the decoder's R 8192, C 384 is
    the kernels phase's R 8192 case."""
    from point_dae_torch.losses import chamfer
    from point_dae_torch.ops import attention, gather, patchify

    g = torch.Generator(device=device).manual_seed(SEED + 80)
    G, S = 64, 32
    for n in (1024, 8192):
        pts = raw[:, :n, :3].contiguous()
        _, knn_idx, match, _ = check_patchify(torch, pts, G, S,
                                              f"masksurf patchify ({MASKSURF_BATCH}, {n})")
        ms = cuda_ms(lambda: patchify.fused_patchify(pts, G, S), 10)
        log(f"  patchify ({MASKSURF_BATCH}, {n}), G {G}, S {S}: {ms:.4f} ms a call; fps_idx "
            f"bit for bit with the plain version, knn idx match {match:.6f}")
        if n == 1024:
            idx = knn_idx.reshape(MASKSURF_BATCH, G * S)
    x6 = raw[:, :1024].contiguous()
    x8 = torch.cat([x6, x6[..., :2]], -1)
    for what, view in (("xyz, C 3", x6[..., :3]), ("normals, C 3", x6[..., 3:]),
                       ("curve attributes, C 5", x8[..., 3:])):
        if not gather.use_small_c_kernel(view, idx.shape[1]):
            fail(f"masksurf: the small-C gather's gate is closed for the {what} view")
        got = gather.gather_rows_small_c(view, idx)
        if not torch.equal(got, gather.gather_rows_small_c_plain(view, idx)):
            fail(f"masksurf: gather_rows_small_c ({what}) differs from the plain version")
        ms = cuda_ms(lambda: gather.gather_rows_small_c(view, idx), 20)
        log(f"  gather_rows_small_c {tuple(view.shape)} by {idx.shape[1]} rows ({what}, the "
            f"strided view copied first): {ms:.4f} ms a call, bit for bit")
    for P, n, m in ((4864, 32, 32), (8192, 32, 32), (8192, 8, 32)):
        x = (torch.randn((P, n, 3), generator=g, device=device) * 0.05).contiguous()
        y = (torch.randn((P, m, 3), generator=g, device=device) * 0.05).contiguous()
        if not chamfer.use_small_kernel(x, m):
            fail(f"masksurf: the patch chamfer's gate is closed at ({P}, {n}, {m})")
        got = chamfer.nn_half_small_pair(x, y)
        want = chamfer.nn_half_small_plain(x, y) + chamfer.nn_half_small_plain(y, x)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"masksurf: the patch chamfer at ({P}, {n}, {m}) differs from the plain halves")
        ms = cuda_ms(lambda: chamfer.nn_half_small_pair(x, y), 20)
        log(f"  patch chamfer {P} pairs of {n} and {m} points, both directions: {ms:.4f} ms "
            f"a call; dist, idx and near bit for bit with the plain halves")
    Bt, T, H, d = MASKSURF_BATCH, 64, 6, 64
    if not attention.supported(Bt, T, H, d):
        fail("masksurf: the attention gate is closed at the decoder's shape")
    bf = torch.bfloat16
    qkv = torch.randn((Bt, T, 3, H, d), generator=g, device=device)
    cot = torch.randn((Bt, T, H, d), generator=g, device=device)

    def run(fn):
        leaf = qkv.clone().requires_grad_()
        q, k, v = leaf.to(bf).unbind(2)
        out = fn(q, k, v, None)
        return out, torch.autograd.grad(out, leaf, cot)[0]

    (ok, gk), (op, gp) = run(attention.fused_attention), run(attention.fused_attention_plain)
    worst = max(rel_err(ok, op), rel_err(gk, gp))
    if worst > 2e-2:
        fail(f"masksurf: fused_attention at ({Bt}, {T}, {H}, {d}) off its plain version: {worst}")
    q, k, v = (t.to(bf) for t in qkv.unbind(2))
    fwd_ms = cuda_ms(lambda: attention.attention_fwd_kernel(q, k, v, None), 20)
    log(f"  fused_attention ({Bt}, {T}, {H}, {d}): forward {fwd_ms:.4f} ms a call; output "
        f"and dq, dk, dv within {worst:.2e} of the plain version's largest")


def masksurf_check(torch, config, raw, device, tol, what):
    """One train-mode forward at MASKSURF_BATCH (every gate of the path
    open) on the card against the CPU with the same weights, clouds and
    draws: each loss within ``tol`` relative. Returns (the card's model,
    the launches of its forward)."""
    from point_dae_torch.engine.pretrain import device_pipeline, init_model
    from point_dae_torch.utils import kernels

    cpu_model = init_model(config, seed=SEED + 81, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED + 82)
    _, clean = device_pipeline(raw, d["aug_type"], d["corrupt_type"], d["npoints"],
                               generator=g, device=device)
    draws = gpu_model.sample_draws(MASKSURF_BATCH, g, device)
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    with torch.no_grad():
        lg = [float(v) for v in gpu_model(clean, clean, draws=draws)]
        used = {k: kernels.launches[k] - before[k] for k in MASKSURF_KERNELS}
        cln = clean.cpu()
        lc = [float(v) for v in cpu_model(cln, cln, draws=on_device(draws, "cpu"))]
    log(f"  {what}, batch {MASKSURF_BATCH}: card losses {lg[0]:.6f} {lg[1]:.6f}; cpu "
        f"({time.perf_counter() - t0:.1f} s) {lc[0]:.6f} {lc[1]:.6f}; launches "
        f"{ {k: v for k, v in used.items() if v} }")
    if not all(math.isfinite(v) for v in lg + lc):
        fail(f"masksurf: non-finite loss in the {what} check")
    if any(abs(a_ - b_) > tol * abs(b_) for a_, b_ in zip(lg, lc)):
        fail(f"masksurf: {what}: card losses {lg} off the CPU's {lc} beyond {tol}")
    del cpu_model
    return gpu_model, used


def phase_masksurf(torch, device, card):
    """The MaskSurf family and the dVAE tokenizer at full width: the path's
    kernels against their plain versions (masksurf_kernels); then for each
    of MASKSURF_RUNS a card-against-CPU check at bs 128 (masksurf_check), 5
    steps with each kernel's launches a step held to the run's, a profiled
    step's busy time, the step time and peak memory."""
    g = torch.Generator(device=device).manual_seed(SEED + 83)
    raw = torch.randn((MASKSURF_BATCH, NRAW, 6), generator=g, device=device)
    raw[..., 3:] /= raw[..., 3:].norm(dim=-1, keepdim=True)
    masksurf_kernels(torch, raw, device)
    records = {}
    for what, path, keys, want, tol in MASKSURF_RUNS:
        config = masksurf_config(path, keys)
        model, used = masksurf_check(torch, config, raw, device, tol, what)
        if min(used[k] for k in want if not k.endswith("_bwd")) == 0:   # a forward: no backward
            fail(f"masksurf: {what}: a kernel gate of the path stayed closed: {used}")
        log(f"  {what}, {MASKSURF_STEPS} steps:")
        steady, first, launches, peak, one_more = run_steps(
            torch, config, raw, device, MASKSURF_STEPS, SEED + 84, model=model)
        per_step = {k: launches[k] / MASKSURF_STEPS for k in MASKSURF_KERNELS}
        if any(per_step[k] != want.get(k, 0) for k in MASKSURF_KERNELS):
            fail(f"masksurf: {what}: launches a step {per_step}, expected {want}")
        busy, _ = profile_step(torch, one_more, card, top=8)
        records[what] = (steady, busy, peak)
        log(f"  [{card}] {what}: step {steady * 1e3:.2f} ms (median of steps "
            f"2-{MASKSURF_STEPS}), {MASKSURF_BATCH / steady:.1f} clouds/s, first step "
            f"{first * 1e3:.1f} ms, busy {busy / 1e3:.2f} ms, max_memory_allocated "
            f"{peak / 2 ** 30:.2f} GiB; launches a step "
            f"{ {k: v for k, v in per_step.items() if v} }")
        del model, one_more
        torch.cuda.empty_cache()
    for what, (st, bz, pk) in records.items():
        log(f"  [{card}] masksurf: {what}: {st * 1e3:.2f} ms a step, busy {bz / 1e3:.2f} ms, "
            f"peak {pk / 2 ** 30:.2f} GiB")


T0 = time.perf_counter()


# -- the data and run layer: the CLI in process, from configs
RUN_FLAGSHIP_CFG = "cfgs/pretrain_synthetic_flagship_cached.yaml"
RUN_FLAGSHIP_CUT = {"max_epoch": 1,                       # epochs 0 and 1
                    "dataset": {"train": {"others": {"size": 768}}}}   # 3 steps an epoch
RUN_DGCNN_CFG = "cfgs/pretrain_synthetic_dgcnn.yaml"       # as shipped
RUN_FT_CFG = {             # cfgs/finetune_synthetic_transformer.yaml at full width
    "optimizer": {"type": "AdamW", "part": "all",
                  "kwargs": {"lr": 0.0005, "weight_decay": 0.05}},
    "scheduler": {"type": "CosLR", "kwargs": {"epochs": 2, "initial_epochs": 0}},
    "dataset": {s: {"_base_": "cfgs/dataset_configs/Synthetic.yaml",
                    "others": {"subset": sub, "npoints": 1024, "size": n, "seed": seed,
                               "aug_type": aug}}
                for s, sub, n, seed, aug in (("train", "train", 64, 0, ["translate", "scale"]),
                                             ("val", "test", 64, 1, ["clean"]),
                                             ("test", "test", 32, 1, ["clean"]))},
    "model": {"NAME": "PointTransformer", "trans_dim": 384, "depth": 12,
              "drop_path_rate": 0.1, "cls_dim": 15, "num_heads": 6, "group_size": 32,
              "num_group": 64, "encoder_dims": 384},
    "npoints": 1024, "total_bs": 32, "step_per_update": 1, "max_epoch": 1,
    "grad_norm_clip": 10}
RUN_PARTSEG_CFG = "cfgs/partseg_shapenetpart.yaml"
RUN_PARTSEG_TREE = {"Airplane": ("02691156", 24, 8), "Chair": ("03001627", 8, 8)}
RUN_PARTSEG_ROWS = 2500    # points a shape file, subsampled to the recipe's 2048
RUN_COUNTERS = FLAGSHIP_COUNTERS + DGCNN_COUNTERS + ("fps", "scatter_rows_add")
MODELNET_PROBE = (9843, 2468, 40)   # ModelNet40's train / test clouds and classes
# the probes' CLI runs: a quarter of ModelNet40's splits, with its tail batches
# (51 and 36 clouds of 64: a tail under 32 takes the plain gather in M2AE's grouping)
PROBE_SET = (38 * 64 + 51, 9 * 64 + 36, 40)
RUN_VOTE_REPEATS = 30               # the fine-tune test's voting passes (the CLI's 299 cut)
PROBE_WIDTHS = (384, 1024)          # the flagship's and the DGCNN encoder's features


def write_config(src, dst, cut):
    """Copy a YAML config with ``_base_`` paths made absolute and the nested
    keys of ``cut`` written over it."""
    import yaml

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = src if isinstance(src, dict) else yaml.safe_load(open(os.path.join(root, src)))
    cfg = copy.deepcopy(cfg)

    def absolute(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "_base_" and isinstance(v, str) and not os.path.isabs(v):
                    node[k] = os.path.join(root, v)
                else:
                    absolute(v)

    def merge(node, over):
        for k, v in over.items():
            if isinstance(v, dict) and isinstance(node.get(k), dict):
                merge(node[k], v)
            else:
                node[k] = v

    absolute(cfg)
    merge(cfg, cut)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return dst


def partseg_tree(root):
    """A ShapeNetPart tree (synsetoffset2category.txt, train_test_split/*.json,
    txt clouds of x y z nx ny nz part) of random shapes with random parts of
    their category."""
    import numpy as np

    from point_dae_torch.engine.partseg import SEG_CLASSES

    rng = np.random.default_rng(SEED + 60)
    os.makedirs(os.path.join(root, "train_test_split"))
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        f.writelines(f"{name}\t{synset}\n" for name, (synset, _, _) in RUN_PARTSEG_TREE.items())
    lists = {"train": [], "test": [], "val": []}
    for name, (synset, n_train, n_test) in RUN_PARTSEG_TREE.items():
        os.makedirs(os.path.join(root, synset))
        for i in range(n_train + n_test):
            sid = f"{name.lower()}{i:03d}"
            data = np.concatenate([rng.normal(size=(RUN_PARTSEG_ROWS, 6)),
                                   rng.choice(SEG_CLASSES[name], (RUN_PARTSEG_ROWS, 1))], 1)
            np.savetxt(os.path.join(root, synset, f"{sid}.txt"), data, fmt="%.6f")
            lists["train" if i < n_train else "test"].append(f"shape_data/{synset}/{sid}")
    for split, ids in lists.items():
        with open(os.path.join(root, "train_test_split", f"shuffled_{split}_file_list.json"),
                  "w") as f:
            json.dump(ids, f)


class LogLines:
    """The lines a run logs under its logger name (the config's stem), and
    the host time of each."""

    def __init__(self, name):
        import logging

        self.logger, self.lines, self.times = logging.getLogger(name), [], []
        self.handler = logging.Handler()
        self.handler.emit = self.emit
        self.logger.addHandler(self.handler)

    def emit(self, record):
        self.times.append(time.perf_counter())
        self.lines.append(record.getMessage())

    def close(self):
        self.logger.removeHandler(self.handler)

    def training(self):
        """(epoch, EpochTime s, [losses]) of each '[Training] EPOCH' line."""
        import re

        out = []
        for ln in self.lines:
            m = re.match(r"^\[Training\] EPOCH: (\d+) EpochTime = (\S+) \(s\) Losses = (.*)$", ln)
            if m:
                out.append((int(m.group(1)), float(m.group(2)),
                            [float(v) for v in json.loads(m.group(3).replace("'", '"'))]))
        return out

    def starting(self, prefix):
        return [ln for ln in self.lines if ln.startswith(prefix)]


def cli_run(what, argv, name, device, epochs, validation=True, ckpts=("ckpt-last",)):
    """Run the port's CLI in process; fail unless it logged a '[Training]
    EPOCH' line for each of ``epochs`` with finite losses, a '[Validation]
    EPOCH' line for each where ``validation``, and wrote ``ckpts``. Returns
    (result, lines, experiment path, seconds)."""
    from point_dae_torch import cli

    lines = LogLines(name)
    t0 = time.perf_counter()
    try:
        out = cli.main(argv, device=device)
    except Exception as e:  # noqa: BLE001 - any failure of the run fails the phase
        fail(f"run {what}: {type(e).__name__}: {e}")
    finally:
        lines.close()
    seconds = time.perf_counter() - t0
    train = lines.training()
    if [e for e, _, _ in train] != list(epochs):
        fail(f"run {what}: [Training] EPOCH lines for epochs {[e for e, _, _ in train]}, "
             f"expected {list(epochs)}")
    if not all(math.isfinite(v) for _, _, losses in train for v in losses):
        fail(f"run {what}: a non-finite loss: {train}")
    val = lines.starting("[Validation] EPOCH: ")
    if validation and len(val) != len(epochs):
        fail(f"run {what}: {len(val)} [Validation] EPOCH lines for {len(epochs)} epochs")
    exp = os.path.join(argv[argv.index("--root_folder") + 1], name,
                       os.path.basename(os.path.dirname(argv[argv.index("--config") + 1])),
                       argv[argv.index("--exp_name") + 1])
    for c in ckpts:
        if not os.path.exists(os.path.join(exp, f"{c}.pth")):
            fail(f"run {what}: no {c}.pth in {exp}")
    for ln in train:
        log(f"    [Training] EPOCH: {ln[0]} EpochTime = {ln[1]:.3f} (s) Losses = {ln[2]}")
    for ln in val:
        log(f"    {ln}")
    return out, lines, exp, seconds


def loop_rate(train, steps, batch):
    """Clouds/s over the epochs after the first (host clock, loader or device
    cache included)."""
    later = [t for e, t, _ in train[1:]]
    return steps * batch * len(later) / sum(later)


def profile_config(torch, config, kind, batch, card, device):
    """The configuration's busy time in one profiled step of a model built
    from it (two steps first), on one batch of its train set."""
    import numpy as np

    from point_dae_torch.data.datasets import build_dataset_from_cfg
    from point_dae_torch.engine import finetune, partseg, pretrain
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import build_model_from_cfg

    train = config["dataset"]["train"]
    ds = build_dataset_from_cfg(train["_base_"], train["others"], device=device)
    items = [ds[i] for i in range(batch)]
    pts = torch.from_numpy(np.stack([it["points"] for it in items]).astype(np.float32))
    g = torch.Generator(device=device).manual_seed(SEED + 61)
    if kind == "pretrain":
        model = pretrain.init_model(config, seed=SEED, device=device)
        step = pretrain.make_train_step(model, config, device=device)
        raw = pts.to(device)
        run = lambda: step(state, raw, generator=g)  # noqa: E731
    elif kind == "finetune":
        model = build_model_from_cfg(config["model"], device=device, seed=SEED)
        step = finetune.make_finetune_step(model, config, device=device)
        labels = torch.tensor([it["label"] for it in items])
        run = lambda: step(state, pts, labels, generator=g)  # noqa: E731
    else:
        model = build_model_from_cfg(config["model"], device=device, seed=SEED)
        step = partseg.make_seg_train_step(model, device=device)
        onehot = torch.eye(16)[torch.tensor([it["label"] for it in items])]
        seg = torch.from_numpy(np.stack([it["seg"] for it in items]))
        run = lambda: step(state, pts, onehot, seg, generator=g)  # noqa: E731
    state = TrainState.create(model, config, 100, config.get("grad_norm_clip"))
    for _ in range(2):
        run()
    busy, _ = profile_step(torch, run, card, top=6)
    del model, state, step
    torch.cuda.empty_cache()
    return busy / 1e3


def svm_probe_times(torch, card, device):
    """evaluate_svm at ModelNet40's probe size on seeded class-structured
    features, on the card at both encoders' widths and on the host CPU at
    the flagship's: seconds for fit + predict, Newton iterations, accuracy."""
    import numpy as np

    from point_dae_torch.engine.pretrain import LinearSVC

    n_train, n_test, classes = MODELNET_PROBE
    rng = np.random.default_rng(SEED + 62)
    out = {}
    for width, dev in [(w, device) for w in PROBE_WIDTHS] + [(PROBE_WIDTHS[0], "cpu")]:
        centers = rng.normal(size=(classes, width))
        y, yt = rng.integers(0, classes, n_train), rng.integers(0, classes, n_test)
        x = (0.3 * centers[y] + rng.normal(size=(n_train, width))).astype(np.float32)
        xt = (0.3 * centers[yt] + rng.normal(size=(n_test, width))).astype(np.float32)
        xd, xtd = torch.from_numpy(x).to(device), torch.from_numpy(xt).to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf = LinearSVC(C=0.01, device=dev).fit(xd, y)
        acc = float((clf.predict(xtd).cpu().numpy() == yt).mean())
        seconds = time.perf_counter() - t0
        if not 1.5 / classes < acc <= 1.0:
            fail(f"SVM probe at width {width} on {dev}: accuracy {acc} near chance")
        where = f"{card}" if dev == device else "host CPU, float64"
        log(f"  [{where}] SVM probe at ModelNet40's size ({n_train} x {width} train, "
            f"{n_test} test, {classes} classes): {seconds:.2f} s fit + predict, "
            f"{clf.n_iter_} Newton iterations, accuracy {acc:.4f}")
        out[(width, str(dev))] = seconds
    return out


def phase_run(torch, device, card):
    """The data and run layer through the CLI (point_dae_torch.cli.main) in a
    temporary directory: the flagship cached pretrain at full width (size and
    epochs cut), the DGCNN pretrain as shipped and its resume, a full-width
    fine-tune warm-started from the flagship's ckpt-last with a test and
    vote from its ckpt-best, one epoch of part segmentation on a ShapeNetPart
    tree with a test; every kernel of those paths launched; each
    configuration's busy time in one profiled step; the SVM probe's time at
    ModelNet40's size."""
    import shutil
    import tempfile

    from point_dae_torch.utils import kernels
    from point_dae_torch.utils.config import cfg_from_yaml_file

    tmp = tempfile.mkdtemp(prefix="chip_smoke_run_")
    exp_root = os.path.join(tmp, "experiments")
    rates = {}
    try:
        kernels.reset_launches()
        # 1. the flagship cached pretrain, full width
        flag = write_config(RUN_FLAGSHIP_CFG, os.path.join(tmp, "cfgs", os.path.basename(
            RUN_FLAGSHIP_CFG)), RUN_FLAGSHIP_CUT)
        log(f"  {RUN_FLAGSHIP_CFG} with {RUN_FLAGSHIP_CUT}:")
        fcfg = cfg_from_yaml_file(flag)
        out, lines, flag_exp, sec = cli_run(
            "flagship", ["--config", flag, "--exp_name", "run", "--root_folder", exp_root],
            "pretrain_synthetic_flagship_cached", device, range(2), validation=False)
        bs = fcfg["total_bs"]
        spe = fcfg["dataset"]["train"]["others"]["size"] // bs      # the cache's floor
        if out["state"].step != 2 * spe:
            fail(f"run flagship: {out['state'].step} optimizer steps, expected {2 * spe}")
        rates["flagship"] = (loop_rate(lines.training(), spe, bs), sec)
        del out
        torch.cuda.empty_cache()

        # 2. the DGCNN pretrain as shipped, then a resume two epochs on
        dg = os.path.join(tmp, "cfgs", os.path.basename(RUN_DGCNN_CFG))
        dg_argv = ["--config", write_config(RUN_DGCNN_CFG, dg, {}), "--exp_name", "run",
                   "--root_folder", exp_root]
        log(f"  {RUN_DGCNN_CFG} as shipped (its _base_ paths made absolute):")
        dcfg = cfg_from_yaml_file(dg)
        out, lines, dg_exp, sec = cli_run("dgcnn", dg_argv, "pretrain_synthetic_dgcnn", device,
                                          range(5), ckpts=("ckpt-best", "ckpt-last"))
        spe, bs = dcfg["dataset"]["train"]["others"]["size"] // dcfg["total_bs"], dcfg["total_bs"]
        if out["state"].step != 5 * spe:
            fail(f"run dgcnn: {out['state'].step} optimizer steps, expected {5 * spe}")
        rates["dgcnn"] = (loop_rate(lines.training(), spe, bs), sec)
        resumed = write_config(RUN_DGCNN_CFG, dg, {"max_epoch": 6})
        log("  the same with --resume and max_epoch 6:")
        out, lines, _, _ = cli_run("dgcnn resume", ["--config", resumed, "--exp_name", "run",
                                                    "--root_folder", exp_root, "--resume"],
                                   "pretrain_synthetic_dgcnn", device, (5, 6))
        if out["state"].step != 7 * spe or not lines.starting("[RESUME] epoch 4"):
            fail(f"run dgcnn resume: did not continue at epoch 5 from step {5 * spe}: "
                 f"{out['state'].step} steps, {lines.starting('[RESUME]')}")
        del out

        # 3. a full-width fine-tune from the flagship's ckpt-last, then a test with votes
        ft = write_config(RUN_FT_CFG, os.path.join(tmp, "cfgs", "finetune_synthetic_full.yaml"),
                          {})
        log(f"  fine-tune (PointTransformer, trans_dim 384, depth 12, G 64 x S 32, bs 32) "
            f"from {flag_exp}/ckpt-last.pth:")
        out, lines, ft_exp, sec = cli_run(
            "finetune", ["--config", ft, "--exp_name", "run", "--root_folder", exp_root,
                         "--finetune_model", "--ckpts",
                         os.path.join(flag_exp, "ckpt-last.pth")],
            "finetune_synthetic_full", device, range(2), ckpts=("ckpt-best", "ckpt-last"))
        merged = lines.starting("[LOAD] merged ")
        if not merged or int(merged[0].split()[2]) == 0:
            fail(f"run finetune: the warm start merged no tensor: {merged}")
        log(f"    {merged[0]}")
        rates["finetune"] = (loop_rate(lines.training(), RUN_FT_CFG["dataset"]["train"]["others"]
                                       ["size"] // RUN_FT_CFG["total_bs"],
                                       RUN_FT_CFG["total_bs"]), sec)
        del out
        t0 = time.perf_counter()
        from point_dae_torch import cli

        get_args = cli.get_args       # the test's voting passes cut to RUN_VOTE_REPEATS
        cli.get_args = lambda argv: setattr(args := get_args(argv), "vote_repeats",
                                            RUN_VOTE_REPEATS) or args
        try:
            out, lines, _, _ = cli_run(
                "finetune test", ["--config", ft, "--exp_name", "run", "--root_folder",
                                  exp_root, "--finetune_model", "--test", "--vote", "--ckpts",
                                  os.path.join(ft_exp, "ckpt-best.pth")],
                "finetune_synthetic_full", device, (), validation=False, ckpts=())
        finally:
            cli.get_args = get_args
        votes = lines.starting("[TEST_VOTE]")
        if not lines.starting("[TEST] acc = ") or len(votes) != RUN_VOTE_REPEATS:
            fail(f"run finetune test: {lines.starting('[TEST]')[:2]}, {len(votes)} vote lines")
        log(f"    {lines.starting('[TEST] acc = ')[0]}; {votes[-1]} "
            f"({time.perf_counter() - t0:.1f} s)")

        # 4. one epoch of part segmentation on a ShapeNetPart tree, then a test
        tree = os.path.join(tmp, "shapenetpart")
        partseg_tree(tree)
        ps = write_config(RUN_PARTSEG_CFG, os.path.join(tmp, "cfgs",
                                                        os.path.basename(RUN_PARTSEG_CFG)),
                          {"max_epoch": 0, "dataset": {s: {"others": {"DATA_PATH": tree}}
                                                       for s in ("train", "test")}})
        log(f"  {RUN_PARTSEG_CFG} with max_epoch 0 on {sum(a + b for _, a, b in RUN_PARTSEG_TREE.values())} "
            f"random shapes of {RUN_PARTSEG_ROWS} points:")
        pcfg = cfg_from_yaml_file(ps)
        lines = LogLines("partseg_shapenetpart")
        from point_dae_torch import cli
        t0 = time.perf_counter()
        try:
            res = cli.main(["--config", ps, "--exp_name", "run", "--root_folder", exp_root],
                           device=device)
            sec = time.perf_counter() - t0
            res_test = cli.main(["--config", ps, "--exp_name", "run", "--root_folder", exp_root,
                                 "--test", "--ckpts", os.path.join(
                                     exp_root, "partseg_shapenetpart", "cfgs", "run",
                                     "best_model.pth")], device=device)
        except Exception as e:  # noqa: BLE001 - any failure of the run fails the phase
            fail(f"run partseg: {type(e).__name__}: {e}")
        finally:
            lines.close()
        loss = lines.starting("Epoch 0 train loss = ")
        if (not loss or not math.isfinite(float(loss[0].split()[5]))
                or not lines.starting("Best inctance avg mIOU is: ")
                or not lines.starting("[TEST] test inctance avg mIOU = ")):
            fail(f"run partseg: lines missing or a non-finite loss: {lines.lines[-8:]}")
        for ln in (loss[0], lines.starting("Epoch 0 test inctance")[0],
                   lines.starting("[TEST] test inctance")[0]):
            log(f"    {ln}")
        ps_steps = sum(a for _, a, _ in RUN_PARTSEG_TREE.values()) // pcfg["total_bs"]
        rates["partseg"] = (ps_steps * pcfg["total_bs"] / sec, sec)
        del res, res_test

        # 5. the dVAE tokenizer, then token_dis with it as dvae_config.ckpt
        dv = write_config(RUN_DVAE_CFG, os.path.join(tmp, "cfgs", os.path.basename(
            RUN_DVAE_CFG)), {})
        log(f"  {RUN_DVAE_CFG} as shipped:")
        _, _, dv_exp, sec = cli_run("dvae", ["--config", dv, "--exp_name", "run",
                                             "--root_folder", exp_root],
                                    "pretrain_synthetic_dvae", device, range(3))
        ckpt = os.path.join(dv_exp, "ckpt-last.pth")
        td = write_config(RUN_TOKENDIS_CFG, os.path.join(tmp, "cfgs", os.path.basename(
            RUN_TOKENDIS_CFG)), {"model": {"dvae_config": {"ckpt": ckpt}}})
        log(f"  {RUN_TOKENDIS_CFG} with model.dvae_config.ckpt {ckpt}:")
        _, lines, _, sec_td = cli_run("token_dis", ["--config", td, "--exp_name", "run",
                                                    "--root_folder", exp_root],
                                      "pretrain_synthetic_masksurf_tokendis", device, range(3))
        merged = lines.starting("[LOAD] merged ")
        if not merged or int(merged[0].split()[2]) == 0:
            fail(f"run token_dis: the tokenizer checkpoint merged no tensor: {merged}")
        log(f"    {merged[0]}; dVAE run {sec:.1f} s, token_dis run {sec_td:.1f} s")

        used = {k: kernels.launches[k] for k in RUN_COUNTERS}
        log(f"  launches over the run phase: {used}")
        if min(used.values()) == 0:
            fail(f"run: a kernel of the run layer's paths was never launched: {used}")

        # each configuration's busy time, one profiled step
        busy = {
            "flagship": profile_config(torch, fcfg, "pretrain", fcfg["total_bs"], card, device),
            "dgcnn": profile_config(torch, dcfg, "pretrain", dcfg["total_bs"], card, device),
            "finetune": profile_config(torch, cfg_from_yaml_file(ft), "finetune",
                                       RUN_FT_CFG["total_bs"], card, device),
            "partseg": profile_config(torch, pcfg, "partseg", pcfg["total_bs"], card, device)}
        for name, (rate, sec) in rates.items():
            over = "the whole run (one epoch, its eval, the set-up)" if name == "partseg" \
                else "the loop's epochs after the first (loader or device cache included)"
            log(f"  [{card}] run {name}: {rate:.1f} clouds/s over {over}, host clock; "
                f"{sec:.1f} s the whole run; busy {busy[name]:.2f} ms in one profiled step "
                f"of the configuration")
        svm_probe_times(torch, card, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the Point-M2AE family at full width (cfgs/pretrain_PointM2AE.yaml as
# shipped): bs 128 from (128, 8192, 6) clouds with unit normals, resampled
# to 2048 points; num_groups 512/256/64, group_sizes 16/8/8, dims
# 96/192/384, depths 5/5/5, 6 heads, decoder 384/192
M2AE_BATCH, M2AE_CHECK_BATCH, M2AE_STEPS, MDAE_STEPS = 128, 32, 5, 2
M2AE_CFG = "cfgs/pretrain_PointM2AE.yaml"
M2AE_FT_CFG = "cfgs/finetune_scan_hardest_tf_pointm2ae.yaml"
M2AE_KERNELS = ("fps", "knn", "gather_rows_small_c", "scatter_rows_add", "nn_half_small",
                "nn_half_tiled")
# launches a pretrain step: FPS 2048 -> 512 and 512 -> 256 (256 -> 64 is
# under the gate); the kNN of scale 1 (256 queries into 512 centres, k 8);
# the xyz groups of scales 0 and 1 (B Q >= 2^18); the backwards of the
# scale-1 token merge (128 2048 96 rows into 512) and of the decoder's
# three_interpolate (128 768 384 into 64); the 32768 patch pairs of 16 and
# 8 points. The MDAE variant adds the tiled chamfer of its scale-0 head
# (512 x 512 points).
_M2AE_STEP = {"fps": 2, "knn": 1, "gather_rows_small_c": 2, "scatter_rows_add": 2,
              "nn_half_small": 1}
M2AE_RUNS = (("Point_M2AE", {}, M2AE_STEPS, _M2AE_STEP),
             ("Point_MDAE_with_fc_center_p ['affine_r3', 'Drop-Patch']",
              {"NAME": "Point_MDAE_with_fc_center_p", "corrupt_type": ["affine_r3", "Drop-Patch"]},
              MDAE_STEPS, dict(_M2AE_STEP, nn_half_tiled=1)))
# the fine-tune at bs 32 of 2048 points (FPS 2048 -> 2048 first): a train
# or eval step launches FPS 3 times, the kNN once, the small-C gather once
# (scale 0: 32 x 8192 rows; scale 1's 32 x 2048 is under its gate); a
# 10-draw vote step ten times that
M2AE_FT_BATCH, M2AE_FT_STEPS, M2AE_VOTES = 32, 5, 10
_M2AE_FT = {"fps": 3, "knn": 1, "gather_rows_small_c": 1}


def m2ae_config(keys):
    """The shipped M2AE pretrain config with ``keys`` written into its model."""
    from point_dae_torch.utils.config import ConfigDict

    config = copy.deepcopy(load_cfg(M2AE_CFG))
    config["model"].update(copy.deepcopy(keys))
    return ConfigDict(config)


def kernel_vs_plain(torch, what, got, want):
    """Fail unless every output of a kernel call equals its plain version's."""
    torch.cuda.synchronize()
    if len(got) != len(want) or not all(torch.equal(a.to(b.dtype), b)
                                        for a, b in zip(got, want)):
        fail(f"{what} differs from its plain version")


def m2ae_kernels(torch, clean, device):
    """Each kernel of the M2AE path against its plain version at the path's
    shapes, bit for bit (the kNN: distances within 1e-5 relative, indices
    differing only at distance ties), with its time a call beside the plain
    version's: FPS at (128, 2048) -> 512 and (128, 512) -> 256; the kNN of
    256 queries into 512 centres, k 8; the small-C gather of both xyz
    groups; the row scatter-add of the scale-1 merge's and of
    three_interpolate's backwards (on the CPU for the plain version, as the
    partseg kernels phase holds it); the patch chamfer over 32768 pairs of
    16 and 8 points; the MDAE head's tiled chamfer (128, 512, 512)."""
    from point_dae_torch.losses import chamfer
    from point_dae_torch.ops import fps, gather, tiled_knn
    from point_dae_torch.ops.geometry import gather_points, three_nn

    g = torch.Generator(device=device).manual_seed(SEED + 90)
    pts = clean[..., :3].contiguous()
    B = pts.shape[0]
    c0 = gather_points(pts, fps.furthest_point_sample(pts, 512))
    c1 = gather_points(c0, fps.furthest_point_sample(c0, 256))
    for src, n in ((pts, 512), (c0, 256)):
        if not fps.use_fps_kernel("cuda", src.shape[1]):
            fail(f"m2ae: the fps gate is closed at {tuple(src.shape)}")
        kernel_vs_plain(torch, f"m2ae: fps {tuple(src.shape)} -> {n}",
                        [fps.furthest_point_sample(src, n)],
                        [fps.furthest_point_sample_plain(src, n)])
        ms = cuda_ms(lambda: fps.furthest_point_sample(src, n), 10)
        plain = cuda_ms(lambda: fps.furthest_point_sample_plain(src, n), 1)
        log(f"  fps {tuple(src.shape)} -> {n}: {ms:.4f} ms a call (plain {plain:.4f}), "
            f"bit for bit")
    dk, ik = tiled_knn.knn_kernel(c1, c0, 8)
    dp, ip = tiled_knn.knn_plain(c1, c0, 8)
    torch.cuda.synchronize()
    differ = ik != ip
    rel = float(((dk - dp).abs() / dp.abs().clamp_min(1e-30)).max())
    if rel > 1e-5 or (differ.any() and not torch.equal(dk[differ], dp[differ])):
        fail(f"m2ae: knn (128, 256, 512, k 8): dists off by {rel:.2e} or idx differ off a tie")
    ms = cuda_ms(lambda: tiled_knn.knn_kernel(c1, c0, 8), 10)
    plain = cuda_ms(lambda: tiled_knn.knn_plain(c1, c0, 8), 2)
    log(f"  knn (128, 256 queries, 512 centres, k 8): {ms:.4f} ms a call (plain {plain:.4f}); "
        f"idx differ at {int(differ.sum())} ties")
    idx0 = tiled_knn.knn_plain(c0, pts, 16)[1].reshape(B, -1)
    for what, x, idx in (("scale 0 (128, 2048, 3) by 8192 rows", pts, idx0),
                         ("scale 1 (128, 512, 3) by 2048 rows", c0, ik.reshape(B, -1))):
        if not gather.use_small_c_kernel(x, idx.shape[1]):
            fail(f"m2ae: the small-C gate is closed at {what}")
        kernel_vs_plain(torch, f"m2ae: gather_rows_small_c {what}",
                        [gather.gather_rows_small_c(x, idx)],
                        [gather.gather_rows_small_c_plain(x, idx)])
        ms = cuda_ms(lambda: gather.gather_rows_small_c(x, idx), 20)
        log(f"  gather_rows_small_c {what}: {ms:.4f} ms a call, bit for bit")
    _, i3 = three_nn(c1, gather_points(c1, fps.furthest_point_sample(c1, 64)))
    for what, idx, N, C in (("the scale-1 merge, (128, 2048) rows of 96 into 512",
                             ik.reshape(B, -1), 512, 96),
                            ("three_interpolate, (128, 768) rows of 384 into 64",
                             i3.reshape(B, -1), 64, 384)):
        if not gather.use_scatter_kernel("cuda", B, idx.shape[1], N, C):
            fail(f"m2ae: the scatter gate is closed at {what}")
        grad = torch.randn((B, idx.shape[1], C), generator=g, device=device)
        got = gather.scatter_rows_add(idx, grad, N)
        want = gather.scatter_rows_add_plain(idx.cpu(), grad.cpu(), N)
        if not torch.equal(got.cpu(), want):
            fail(f"m2ae: scatter_rows_add at {what} differs from the plain version on the CPU")
        ms = cuda_ms(lambda: gather.scatter_rows_add(idx, grad, N), 20)
        plain = cuda_ms(lambda: gather.scatter_rows_add_plain(idx, grad, N), 5)
        log(f"  scatter_rows_add at {what}: {ms:.4f} ms a call (plain {plain:.4f}), bit for "
            f"bit with the plain version on the CPU")
    x = (torch.randn((B * 256, 16, 3), generator=g, device=device) * 0.05).contiguous()
    y = (torch.randn((B * 256, 8, 3), generator=g, device=device) * 0.05).contiguous()
    if not chamfer.use_small_kernel(x, 8):
        fail("m2ae: the patch chamfer's gate is closed at 32768 pairs of 16 and 8")
    kernel_vs_plain(torch, "m2ae: the patch chamfer (32768, 16, 8)",
                    chamfer.nn_half_small_pair(x, y),
                    chamfer.nn_half_small_plain(x, y) + chamfer.nn_half_small_plain(y, x))
    ms = cuda_ms(lambda: chamfer.nn_half_small_pair(x, y), 20)
    log(f"  patch chamfer 32768 pairs of 16 and 8 points, both directions: {ms:.4f} ms a call, "
        f"bit for bit with the plain halves")
    x = torch.randn((B, 512, 3), generator=g, device=device)
    if not chamfer.use_tiled_kernel(x, 512):
        fail("m2ae: the tiled chamfer's gate is closed at (128, 512, 512)")
    kernel_vs_plain(torch, "m2ae: the tiled chamfer (128, 512, 512)",
                    chamfer.nn_half_tiled_pair(x, c0),
                    chamfer.nn_half_tiled_plain(x, c0) + chamfer.nn_half_tiled_plain(c0, x))
    ms = cuda_ms(lambda: chamfer.nn_half_tiled_pair(x, c0), 20)
    log(f"  tiled chamfer (128, 512, 512), both directions: {ms:.4f} ms a call, bit for bit")


def m2ae_check(torch, config, clean, device, what):
    """One train-mode forward at M2AE_CHECK_BATCH (every forward gate of the
    path open but the scale-1 gather's, which needs 128 clouds) on the card
    against the CPU with the same weights, clouds and draws: each loss
    within 1e-4 relative. The pyramids' kNN picks that differ between the
    card and the CPU (near-ties of the distance rounding) are counted.
    Returns the card's model."""
    from point_dae_torch.engine.pretrain import init_model
    from point_dae_torch.utils import kernels

    cpu_model = init_model(config, seed=SEED + 91, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    cln = clean[:M2AE_CHECK_BATCH]
    g = torch.Generator(device=device).manual_seed(SEED + 92)
    draws = gpu_model.sample_draws(M2AE_CHECK_BATCH, g, device)
    before = dict(kernels.launches)
    t0 = time.perf_counter()
    with torch.no_grad():
        lg = [float(v) for v in gpu_model(cln, cln, draws=draws)]
        used = {k: kernels.launches[k] - before[k] for k in M2AE_KERNELS}
        _, _, ig = gpu_model._group(cln)
        c = cln.cpu()
        lc = [float(v) for v in cpu_model(c, c, draws=on_device(draws, "cpu"))]
        _, _, ic = cpu_model._group(c)
    flips = [int((a.cpu() != b).sum()) for a, b in zip(ig, ic)]
    log(f"  {what}, batch {M2AE_CHECK_BATCH}: card losses {lg[0]:.7f} {lg[1]:.7f}; cpu "
        f"({time.perf_counter() - t0:.1f} s) {lc[0]:.7f} {lc[1]:.7f}; kNN picks that differ "
        f"by scale {flips}; launches { {k: v for k, v in used.items() if v} }")
    if not all(math.isfinite(v) for v in lg + lc):
        fail(f"m2ae: non-finite loss in the {what} check")
    if any(abs(a_ - b_) > 1e-4 * abs(b_) for a_, b_ in zip(lg, lc)):
        fail(f"m2ae: {what}: card losses {lg} off the CPU's {lc} beyond 1e-4 relative")
    if min(used[k] for k in ("fps", "knn", "gather_rows_small_c", "nn_half_small")) == 0:
        fail(f"m2ae: {what}: a forward kernel gate stayed closed: {used}")
    del cpu_model
    return gpu_model


def m2ae_finetune(torch, device, card):
    """cfgs/finetune_scan_hardest_tf_pointm2ae.yaml at bs 32 of 2048
    points: eval logits on the card against the CPU, then M2AE_FT_STEPS train
    steps, a profiled one, an eval step and a vote step, each with its
    launches held to _M2AE_FT. Returns (step, busy, peak)."""
    import numpy as np

    from point_dae_torch.engine import finetune
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.utils import kernels

    config = load_cfg(M2AE_FT_CFG)
    rng = np.random.default_rng(SEED + 93)
    pts = torch.from_numpy(rng.normal(size=(M2AE_FT_BATCH, 2048, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, config["model"]["cls_dim"], M2AE_FT_BATCH))
    cpu_model = build_model_from_cfg(config["model"], device="cpu", seed=SEED + 94)
    model = copy.deepcopy(cpu_model).to(device)
    eval_step = finetune.make_eval_step(model, config, device=device)
    kernels.reset_launches()
    lg = eval_step(pts.to(device))
    torch.cuda.synchronize()
    used = {k: kernels.launches[k] for k in _M2AE_FT}
    t0 = time.perf_counter()
    lc = finetune.make_eval_step(cpu_model, config, device="cpu")(pts)
    err = float((lg.cpu() - lc).abs().max() / lc.abs().max())
    log(f"  fine-tune eval logits (32, 2048) on the card against the CPU "
        f"({time.perf_counter() - t0:.1f} s): {err:.2e} of the largest; launches {used}")
    if err > 1e-4 or used != _M2AE_FT:
        fail(f"m2ae: fine-tune eval: logits off the CPU's by {err:.2e} or launches {used}, "
             f"expected {_M2AE_FT}")
    del cpu_model
    state = TrainState.create(model, config, 100, config.get("grad_norm_clip"))
    step = finetune.make_finetune_step(model, config, device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 95)
    pd, ld = pts.to(device), labels.to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for _ in range(M2AE_FT_STEPS):
        t0 = time.perf_counter()
        m = step(state, pd, ld, generator=g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_step = {k: kernels.launches[k] / M2AE_FT_STEPS for k in _M2AE_FT}
    peak = torch.cuda.max_memory_allocated()
    if per_step != _M2AE_FT or not math.isfinite(float(m["loss"])):
        fail(f"m2ae: fine-tune train: launches a step {per_step} (expected {_M2AE_FT}) or loss "
             f"{float(m['loss'])}")
    steady = sorted(times[1:])[(M2AE_FT_STEPS - 2) // 2]
    busy, _ = profile_step(torch, lambda: step(state, pd, ld, generator=g), card, top=6)
    eval_ms = cuda_ms(lambda: eval_step(pd), 3)
    vote = finetune.make_vote_step(model, config, times=M2AE_VOTES, device=device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    vote(pd, generator=g)
    torch.cuda.synchronize()
    vote_ms = (time.perf_counter() - t0) * 1e3
    vote_used = {k: kernels.launches[k] for k in _M2AE_FT}
    if vote_used != {k: v * M2AE_VOTES for k, v in _M2AE_FT.items()}:
        fail(f"m2ae: the vote step launched {vote_used}")
    log(f"  [{card}] M2AE fine-tune (bs 32 of 2048): train step {steady * 1e3:.2f} ms (median "
        f"of steps 2-{M2AE_FT_STEPS}), loss {float(m['loss']):.4f}, busy {busy / 1e3:.2f} ms, "
        f"peak {peak / 2 ** 30:.2f} GiB; launches a step {per_step}; eval step {eval_ms:.2f} "
        f"ms; vote step ({M2AE_VOTES} draws) {vote_ms:.1f} ms, launches {vote_used}")
    del model, state, step
    torch.cuda.empty_cache()
    return steady, busy, peak


def phase_m2ae(torch, device, card):
    """The Point-M2AE family at full width: the path's kernels against their
    plain versions (m2ae_kernels); Point_M2AE and the MDAE variant each on
    the card against the CPU (m2ae_check), then their steps with each
    kernel's launches a step held to the run's, a profiled step's busy time,
    the step time and peak memory; then the fine-tune (m2ae_finetune)."""
    from point_dae_torch.engine.pretrain import device_pipeline

    g = torch.Generator(device=device).manual_seed(SEED + 96)
    raw = torch.randn((M2AE_BATCH, NRAW, 6), generator=g, device=device)
    raw[..., 3:] /= raw[..., 3:].norm(dim=-1, keepdim=True)
    base = m2ae_config({})
    d = base["dataset"]["train"]["others"]
    _, clean = device_pipeline(raw, d["aug_type"], d["corrupt_type"], d["npoints"],
                               generator=g, device=device)
    m2ae_kernels(torch, clean, device)
    torch.cuda.empty_cache()
    records = {}
    for what, keys, steps, want in M2AE_RUNS:
        config = m2ae_config(keys)
        model = m2ae_check(torch, config, clean, device, what)
        log(f"  {what}, {steps} steps at bs {M2AE_BATCH}:")
        steady, first, launches, peak, one_more = run_steps(
            torch, config, raw, device, steps, SEED + 97, model=model)
        per_step = {k: launches[k] / steps for k in M2AE_KERNELS}
        if any(per_step[k] != want.get(k, 0) for k in M2AE_KERNELS):
            fail(f"m2ae: {what}: launches a step {per_step}, expected {want}")
        busy, _ = profile_step(torch, one_more, card, top=8)
        records[what] = (steady, busy, peak)
        log(f"  [{card}] {what}: step {steady * 1e3:.2f} ms (median of steps 2-{steps}), "
            f"{M2AE_BATCH / steady:.1f} clouds/s, first step {first * 1e3:.1f} ms, busy "
            f"{busy / 1e3:.2f} ms, max_memory_allocated {peak / 2 ** 30:.2f} GiB; launches a "
            f"step { {k: v for k, v in per_step.items() if v} }")
        del model, one_more
        torch.cuda.empty_cache()
    records["Point_M2AE_Finetune (bs 32 of 2048)"] = m2ae_finetune(torch, device, card)
    for what, (st, bz, pk) in records.items():
        log(f"  [{card}] m2ae: {what}: {st * 1e3:.2f} ms a step, busy {bz / 1e3:.2f} ms, "
            f"peak {pk / 2 ** 30:.2f} GiB")


# -- the frozen-feature probes through the CLI: both modes on the Synthetic
# reader at a quarter of ModelNet40's split sizes (PROBE_SET), the configs' npoints
PROBE_RUNS = (   # (what, shipped config, CLI flag, launches an extraction batch)
    ("DGCNN_feat SVM", "cfgs/finetune_modelnet_svm_classification.yaml",
     "--svm_classification", {"fps": 1, "knn_aggregate_fwd": 4}),
    ("Point_M2AE_SVMFeature SVM", "cfgs/generated/finetune_modelnet_svm_pointm2ae.yaml",
     "--svm_classification", {"fps": 3, "knn": 1, "gather_rows_small_c": 1}),
    ("DGCNN_feat task affinity", "cfgs/finetune_modelnet_taskaffinity.yaml",
     "--task_affinity", {"fps": 1, "knn_aggregate_fwd": 4}))
PROBE_SVC_CLASSES, PROBE_SVC_C = 8, 1.0   # the card-against-CPU SVC fit


def probe_cli(torch, what, src, flag, per_batch, tmp, device):
    """One probe mode through point_dae_torch.cli.main on a copy of ``src``
    whose splits are Synthetic clouds at PROBE_SET's sizes: the seconds of
    its extraction, of its SVC fits (each C's SMO iterations) or of its
    affinity head, its log lines, and the inputs of its grid search."""
    from point_dae_torch import cli
    from point_dae_torch.engine import probe
    from point_dae_torch.utils import kernels

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_cfg(src)
    npoints = int(cfg["npoints"])
    syn = os.path.join(root, "cfgs", "dataset_configs", "Synthetic.yaml")
    n_train, n_test, classes = PROBE_SET
    cut = {"dataset": {s: {"_base_": syn, "others": {"size": n, "seed": seed, "N_POINTS": npoints,
                                                     "num_classes": classes}}
                       for s, n, seed in (("train", n_train, 0), ("test", n_test, 1))}}
    stem = "probe_" + os.path.splitext(os.path.basename(src))[0]
    path = write_config(src, os.path.join(tmp, "cfgs", stem + ".yaml"), cut)
    seconds = {"extract": 0.0, "fits": [], "head": 0.0}
    grid_inputs = []
    orig = (probe.extract_features, probe.svm_grid_search, probe.fit_linear_head, probe.SVC)

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[key] += time.perf_counter() - t0
            return out
        return run

    class TimedSVC(orig[3]):
        def fit(self, X, y):
            t0 = time.perf_counter()
            super().fit(X, y)
            torch.cuda.synchronize()
            seconds["fits"].append((self.C, self.n_iter_, time.perf_counter() - t0,
                                    self.converged_))
            return self

    probe.extract_features = timed("extract", orig[0])
    probe.svm_grid_search = lambda *a, **k: grid_inputs.append(a[:4]) or orig[1](*a, **k)
    probe.fit_linear_head = timed("head", orig[2])
    probe.SVC = TimedSVC
    lines = LogLines(stem)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = cli.main(["--config", path, flag, "--exp_name", "probe", "--root_folder",
                        os.path.join(tmp, "experiments")], device=device)
    except Exception as e:  # noqa: BLE001 - any failure of the run fails the phase
        fail(f"probe {what}: {type(e).__name__}: {e}")
    finally:
        lines.close()
        probe.extract_features, probe.svm_grid_search, probe.fit_linear_head, probe.SVC = orig
    total = time.perf_counter() - t0
    batches = sum(-(-n // 64) for n in (n_train, n_test))
    used = {k: kernels.launches[k] for k in per_batch}
    if used != {k: v * batches for k, v in per_batch.items()}:
        fail(f"probe {what}: launches {used} over {batches} extraction batches, expected "
             f"{per_batch} a batch")
    wanted = ("[SVM]",) if flag == "--svm_classification" else ("[TaskAffinity]", "[Validation]")
    shown = [ln for ln in lines.lines if ln.startswith(wanted)]
    if len(shown) != (7 if flag == "--svm_classification" else 2) or not math.isfinite(out):
        fail(f"probe {what}: result {out}, log lines {shown}")
    for ln in shown:
        log(f"    {ln}")
    return out, seconds, total, used, batches, grid_inputs


def probe_kernels(torch, device):
    """The probes' kernels against their plain versions at their shapes, bit
    for bit: FPS at an extraction batch of 64 clouds, (64, 1024) -> 1024
    and (64, 2048) -> 2048; DGCNN_feat's first EdgeConv forward
    (knn_aggregate at (64, 1024), Cf 3, C 64, k 20: neighbours, maxima,
    minima and sums)."""
    from point_dae_torch.ops import edgeconv, fps

    g = torch.Generator(device=device).manual_seed(SEED + 98)
    for n in (1024, 2048):
        pts = torch.randn((64, n, 3), generator=g, device=device)
        kernel_vs_plain(torch, f"probe: fps (64, {n}) -> {n}",
                        [fps.furthest_point_sample(pts, n)],
                        [fps.furthest_point_sample_plain(pts, n)])
        ms = cuda_ms(lambda: fps.furthest_point_sample(pts, n), 10)
        log(f"  fps (64, {n}) -> {n}: {ms:.4f} ms a call, bit for bit")
    xf = torch.randn((64, 1024, 3), generator=g, device=device)
    U = torch.randn((64, 1024, 64), generator=g, device=device).bfloat16().float()
    outk = edgeconv.knn_aggregate_fwd_kernel(U, xf, 20, True)
    idx = edgeconv.knn_select_plain(xf, 20)
    kernel_vs_plain(torch, "probe: knn_aggregate (64, 1024, C 64, k 20)",
                    list(outk[:5]), list(edgeconv.aggregate_plain(U, idx)[:4]) + [idx])
    ms = cuda_ms(lambda: edgeconv.knn_aggregate_fwd_kernel(U, xf, 20, True), 10)
    log(f"  knn_aggregate forward (64, 1024, C 64, k 20): {ms:.4f} ms a call, bit for bit")


def phase_probe(torch, device, card):
    """The probes' kernels at their shapes (probe_kernels); then the
    frozen-feature probes through the CLI in process (PROBE_RUNS),
    each printed with its seconds (extraction, each SVC fit with its SMO
    iterations, the affinity head) and its launches; then the port's SVC
    fitted on the card and on the host CPU over the same features (the
    M2AE grid's, its first PROBE_SVC_CLASSES classes, C PROBE_SVC_C): the
    predictions must be equal."""
    import shutil
    import tempfile

    import numpy as np

    from point_dae_torch.engine.probe import SVC

    probe_kernels(torch, device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_probe_")
    try:
        grids = {}
        for what, src, flag, per_batch in PROBE_RUNS:
            out, sec, total, used, batches, grid = probe_cli(torch, what, src, flag, per_batch,
                                                             tmp, device)
            fits = ", ".join(f"C {c:g} {n} iterations {s:.2f} s" + ("" if ok else " NOT CONVERGED")
                             for c, n, s, ok in sec["fits"])
            log(f"  [{card}] probe {what}: result {out:.4f}; {total:.1f} s in all, extraction "
                f"{sec['extract']:.1f} s ({batches} batches of 64, launches {used}), "
                + (f"SVC grid {sum(s for _, _, s, _ in sec['fits']):.2f} s ({fits})"
                   if sec["fits"] else f"affinity head (300 epochs) {sec['head']:.2f} s"))
            if not all(ok for *_, ok in sec["fits"]):
                fail(f"probe {what}: an SVC fit stopped at its iteration cap")
            if grid:
                grids[what] = grid[0]
        tr_f, tr_l, te_f, te_l = grids["Point_M2AE_SVMFeature SVM"]
        tr = np.flatnonzero(np.asarray(tr_l) < PROBE_SVC_CLASSES)
        te = np.flatnonzero(np.asarray(te_l) < PROBE_SVC_CLASSES)
        x, xt = tr_f[torch.from_numpy(tr).to(device)], te_f[torch.from_numpy(te).to(device)]
        preds, secs = [], []
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            clf = SVC(C=PROBE_SVC_C, device=dev).fit(x, tr_l[tr])
            preds.append(clf.predict(xt).cpu())
            secs.append((time.perf_counter() - t0, clf.n_iter_))
        same = int((preds[0] == preds[1]).sum())
        log(f"  SVC (C {PROBE_SVC_C:g}) over the M2AE features of {PROBE_SVC_CLASSES} classes "
            f"({len(tr)} x {x.shape[1]} train, {len(te)} test): [{card}] {secs[0][0]:.2f} s, "
            f"{secs[0][1]} iterations; host CPU {secs[1][0]:.2f} s, {secs[1][1]} iterations; "
            f"predictions equal on {same} of {len(te)}")
        if same != len(te):
            fail("probe: the SVC's predictions on the card differ from its CPU fit's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the backbones of the pretrain zoo (3DETR, Point-MAE, the transformer
# MaskFeat) and the fine-tunes of the optimizer's part modes and PointNet++,
# each at its shipped widths
BACKBONE_BATCH, BACKBONE_STEPS = 128, 3
DETR_CFG = ("cfgs/generated/pretrain_PointCAE_transformer_dropout_patch_affine_r3_maskpatch_"
            "p0005_3detr.yaml")
BACKBONE_RUNS = (   # (what, shipped config, launches a step)
    ("3DETR", DETR_CFG, {"fps": 1, "gather_rows_small_c": 2, "nn_half_small": 1}),
    ("Point_MAE", "cfgs/pretrain_PointMAE.yaml",
     {"patchify": 1, "gather_rows_small_c": 1, "nn_half_small": 1}),
    ("MaskFeat_transformer", "cfgs/pretrain_MaskFeat_transformer.yaml",
     {"patchify": 1, "gather_rows_small_c": 1}))
PART_BATCH, PART_STEPS = 32, 3
PART_RUNS = (       # (what, shipped config, points a cloud, launches a train step)
    ("linear probe (only_new)", "cfgs/generated/finetune_scan_objbg_linear_classification.yaml",
     2048, {"fps": 1, "patchify": 1}),
    ("non-linear head (only_new)",
     "cfgs/generated/finetune_scan_objbg_non_linear_classification.yaml", 2048,
     {"fps": 1, "patchify": 1}),
    ("diff_lr", "cfgs/generated/finetune_scan_objbg_transferring_features_diff_lr.yaml", 2048,
     {"fps": 1, "patchify": 1}),
    ("PointNetv2", "cfgs/generated/finetune_modelnet_transferring_features_PointNetv2.yaml",
     1024, {"fps": 3, "gather_rows_small_c": 2, "scatter_rows_add": 1}))
RUN_LINEAR_CUT = {  # the linear probe's CLI run on Synthetic clouds, one epoch
    "dataset": {s: {"_base_": "cfgs/dataset_configs/Synthetic.yaml",
                    "others": {"subset": sub, "npoints": 2048, "size": n, "seed": seed,
                               "aug_type": ["clean"]}}
                for s, sub, n, seed in (("train", "train", 64, 0), ("val", "test", 32, 1),
                                        ("test", "test", 32, 1))},
    "max_epoch": 0, "model": {"cls_dim": 15}}
RUN_DETR_CUT = {    # the 3DETR pretrain's CLI run on Synthetic clouds, one epoch
    "dataset": {s: {"_base_": "cfgs/dataset_configs/Synthetic.yaml",
                    "others": dict(o, subset=sub, npoints=1024, size=n, seed=seed)}
                for s, sub, n, seed, o in (
                    ("train", "train", 256, 0, {"aug_type": ["norm"], "corrupt_type": ["clean"]}),
                    ("val", "test", 64, 1, {"aug_type": ["clean"]}),
                    ("extra_train", "train", 64, 2, {"aug_type": ["clean"]}))},
    "max_epoch": 0}


def launches_a_step(steps):
    """Every launch counter's count a step over the last ``steps`` steps
    (the counters zeroed before them), the counters at 0 left out."""
    from point_dae_torch.utils import kernels

    return {k: v / steps for k, v in kernels.launches.items() if v}


def zoo_kernels(torch, raw, device):
    """Each kernel of the slice's paths against its plain version at the
    paths' shapes, bit for bit, with its time a call: fps at 3DETR's (128,
    1024) -> 64 and PointNet++'s (32, 1024) -> 512 and (32, 512) -> 128;
    the small-C gather of the ball queries' xyz groups (3DETR: 2048 rows a
    cloud; PointNet++: 16384 and 8192); the row scatter-add of PointNet++'s
    sa2 feature gather's backward ((32, 8192) rows of 128 into 512), against
    the plain version on the CPU; the patch chamfer over 3DETR's 6528
    masked patches of 32 and 32 points; patchify at (128, 1024) G 64 and at
    the fine-tunes' (32, 2048) and (32, 8192) G 128."""
    from point_dae_torch.losses import chamfer
    from point_dae_torch.ops import fps, gather, patchify
    from point_dae_torch.ops.geometry import ball_query, gather_points

    g = torch.Generator(device=device).manual_seed(SEED + 100)
    pts = raw[:, :1024, :3].contiguous()
    ft = torch.randn((PART_BATCH, 1024, 3), generator=g, device=device)
    c64 = gather_points(pts, fps.furthest_point_sample(pts, 64))
    c512 = gather_points(ft, fps.furthest_point_sample(ft, 512))
    for src, n in ((pts, 64), (ft, 512), (c512, 128)):
        if not fps.use_fps_kernel("cuda", src.shape[1]):
            fail(f"zoo: the fps gate is closed at {tuple(src.shape)}")
        kernel_vs_plain(torch, f"zoo: fps {tuple(src.shape)} -> {n}",
                        [fps.furthest_point_sample(src, n)],
                        [fps.furthest_point_sample_plain(src, n)])
        ms = cuda_ms(lambda: fps.furthest_point_sample(src, n), 10)
        log(f"  fps {tuple(src.shape)} -> {n}: {ms:.4f} ms a call, bit for bit")
    c128 = gather_points(c512, fps.furthest_point_sample(c512, 128))
    groups = (("3DETR's balls (128, 1024, 3) by 64 x 32", pts, ball_query(0.2, 32, pts, c64)),
              ("sa1's balls (32, 1024, 3) by 512 x 32", ft, ball_query(0.2, 32, ft, c512)),
              ("sa2's balls (32, 512, 3) by 128 x 64", c512, ball_query(0.4, 64, c512, c128)))
    for what, x, nidx in groups:
        idx = nidx.reshape(x.shape[0], -1)
        if not gather.use_small_c_kernel(x, idx.shape[1]):
            fail(f"zoo: the small-C gate is closed at {what}")
        kernel_vs_plain(torch, f"zoo: gather_rows_small_c {what}",
                        [gather.gather_rows_small_c(x, idx)],
                        [gather.gather_rows_small_c_plain(x, idx)])
        ms = cuda_ms(lambda: gather.gather_rows_small_c(x, idx), 20)
        log(f"  gather_rows_small_c {what}: {ms:.4f} ms a call, bit for bit")
    idx = groups[2][2].reshape(PART_BATCH, -1)
    if not gather.use_scatter_kernel("cuda", PART_BATCH, idx.shape[1], 512, 128):
        fail("zoo: the scatter gate is closed at sa2's feature gather")
    grad = torch.randn((PART_BATCH, idx.shape[1], 128), generator=g, device=device)
    got = gather.scatter_rows_add(idx, grad, 512)
    if not torch.equal(got.cpu(), gather.scatter_rows_add_plain(idx.cpu(), grad.cpu(), 512)):
        fail("zoo: scatter_rows_add at sa2's feature gather differs from the plain version")
    ms = cuda_ms(lambda: gather.scatter_rows_add(idx, grad, 512), 20)
    log(f"  scatter_rows_add (32, 8192) rows of 128 into 512: {ms:.4f} ms a call, bit for bit "
        f"with the plain version on the CPU")
    x = (torch.randn((BACKBONE_BATCH * 51, 32, 3), generator=g, device=device) * 0.2).contiguous()
    y = (torch.randn((BACKBONE_BATCH * 51, 32, 3), generator=g, device=device) * 0.2).contiguous()
    if not chamfer.use_small_kernel(x, 32):
        fail("zoo: the patch chamfer's gate is closed at 3DETR's masked patches")
    kernel_vs_plain(torch, "zoo: the patch chamfer (6528, 32, 32)",
                    chamfer.nn_half_small_pair(x, y),
                    chamfer.nn_half_small_plain(x, y) + chamfer.nn_half_small_plain(y, x))
    ms = cuda_ms(lambda: chamfer.nn_half_small_pair(x, y), 20)
    log(f"  patch chamfer 6528 pairs of 32 and 32 points, both directions: {ms:.4f} ms a call, "
        f"bit for bit with the plain halves")
    for B, N, G in ((BACKBONE_BATCH, 1024, 64), (PART_BATCH, 2048, 128), (PART_BATCH, 8192, 128)):
        p = pts if N == 1024 else torch.randn((B, N, 3), generator=g, device=device)
        _, _, match, gap = check_patchify(torch, p, G, 32, f"zoo: patchify ({B}, {N}) G {G}")
        ms = cuda_ms(lambda: patchify.fused_patchify(p, G, 32), 10)
        log(f"  patchify ({B}, {N}) G {G} S 32: {ms:.4f} ms a call; kNN indices equal "
            f"{100 * match:.4f}%, selected distances within {gap:.1e}")


def phase_backbones(torch, device, card):
    """The pretrain models of the slice at their shipped configs from (128,
    8192, 6) raw clouds: the kernels at the paths' shapes (zoo_kernels);
    each model's train-mode forward at batch 128 (every gate open) on the
    card against the CPU with the same weights, clouds and draws, both
    losses within 1e-4 relative; BACKBONE_STEPS steps with every launch
    counter a step held to BACKBONE_RUNS, a profiled step's busy time, the
    step time and peak memory; then 3DETR's pretrain through the CLI on
    Synthetic clouds (one epoch of 2 steps, the SVM probe through
    ``encode``)."""
    import shutil
    import tempfile

    from point_dae_torch.engine.pretrain import device_pipeline, init_model

    g = torch.Generator(device=device).manual_seed(SEED + 101)
    raw = torch.randn((BACKBONE_BATCH, NRAW, 6), generator=g, device=device)
    raw[..., 3:] /= raw[..., 3:].norm(dim=-1, keepdim=True)
    zoo_kernels(torch, raw, device)
    records = {}
    for what, path, want in BACKBONE_RUNS:
        config = load_cfg(path)
        d = config["dataset"]["train"]["others"]
        cor, cln = device_pipeline(raw, d["aug_type"], d["corrupt_type"], d["npoints"],
                                   generator=g, device=device)
        cpu_model = init_model(config, seed=SEED + 102, device="cpu")
        model = copy.deepcopy(cpu_model).to(device)
        draws = model.sample_draws(BACKBONE_BATCH, g, device)
        t0 = time.perf_counter()
        with torch.no_grad():
            lg = [float(v) for v in model(cor, cln, draws=draws)]
            lc = [float(v) for v in cpu_model(cor.cpu(), cln.cpu(), draws=on_device(draws, "cpu"))]
        log(f"  {what} ({path}), batch {BACKBONE_BATCH}: card losses {lg[0]:.7f} {lg[1]:.7f}; "
            f"cpu ({time.perf_counter() - t0:.1f} s) {lc[0]:.7f} {lc[1]:.7f}")
        if not all(math.isfinite(v) for v in lg + lc) or any(
                abs(a - b) > 1e-4 * abs(b) for a, b in zip(lg, lc)):
            fail(f"zoo: {what}: card losses {lg} off the CPU's {lc} beyond 1e-4 relative")
        del cpu_model
        steady, first, launches, peak, one_more = run_steps(
            torch, config, raw, device, BACKBONE_STEPS, SEED + 103, model=model)
        per_step = {k: v / BACKBONE_STEPS for k, v in launches.items() if v}
        if per_step != want:
            fail(f"zoo: {what}: launches a step {per_step}, expected {want}")
        busy, _ = profile_step(torch, one_more, card, top=6)
        records[what] = (steady, busy, peak)
        log(f"  [{card}] {what}: step {steady * 1e3:.2f} ms (median of steps 2-{BACKBONE_STEPS}), "
            f"{BACKBONE_BATCH / steady:.1f} clouds/s, first step {first * 1e3:.1f} ms, busy "
            f"{busy / 1e3:.2f} ms, max_memory_allocated {peak / 2 ** 30:.2f} GiB; launches a step "
            f"{per_step}")
        del model, one_more
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        cfg = write_config(DETR_CFG, os.path.join(tmp, "cfgs", os.path.basename(DETR_CFG)),
                           RUN_DETR_CUT)
        name = os.path.splitext(os.path.basename(DETR_CFG))[0]
        log(f"  {DETR_CFG} through the CLI on Synthetic clouds (256 train, one epoch):")
        out, lines, _, sec = cli_run("3DETR pretrain", ["--config", cfg, "--exp_name", "run",
                                                        "--root_folder", tmp], name, device,
                                     range(1))
        if out["state"].step != 2:
            fail(f"run 3DETR pretrain: {out['state'].step} optimizer steps, expected 2")
        log(f"  [{card}] 3DETR pretrain through the CLI: {sec:.1f} s, best SVM acc "
            f"{out['best_acc']:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for what, (st, bz, pk) in records.items():
        log(f"  [{card}] zoo: {what} (bs {BACKBONE_BATCH}): {st * 1e3:.2f} ms a step, busy "
            f"{bz / 1e3:.2f} ms, peak {pk / 2 ** 30:.2f} GiB")


def part_mode_run(torch, what, path, n, want, device, card):
    """One fine-tune configuration at bs 32 of ``n`` points: eval logits on
    the card against the CPU (within 1e-4 of the largest; launches of the
    eval held to the train step's less the backward's), PART_STEPS train
    steps with each launch counter a step held to ``want``; under
    ``only_new`` every parameter but the ``cls`` ones and every BatchNorm
    statistic unchanged, the ``cls`` ones moved; a profiled step. Returns
    (step time, busy, peak)."""
    import numpy as np

    from point_dae_torch.engine import finetune
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.utils import kernels

    config = load_cfg(path)
    rng = np.random.default_rng(SEED + 104)
    pts = torch.from_numpy(rng.normal(size=(PART_BATCH, n, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, config["model"]["cls_dim"], PART_BATCH))
    cpu_model = build_model_from_cfg(config["model"], device="cpu", seed=SEED + 105)
    model = copy.deepcopy(cpu_model).to(device)
    eval_step = finetune.make_eval_step(model, config, device=device)
    kernels.reset_launches()
    lg = eval_step(pts.to(device))
    torch.cuda.synchronize()
    used = launches_a_step(1)
    t0 = time.perf_counter()
    lc = finetune.make_eval_step(cpu_model, config, device="cpu")(pts)
    err = float((lg.cpu() - lc).abs().max() / lc.abs().max())
    want_eval = {k: v for k, v in want.items() if k != "scatter_rows_add"}
    log(f"  {what} ({path}): eval logits ({PART_BATCH}, {n}) on the card against the CPU "
        f"({time.perf_counter() - t0:.1f} s): {err:.2e} of the largest; launches {used}")
    if err > 1e-4 or used != want_eval:
        fail(f"zoo: {what}: eval logits off the CPU's by {err:.2e} or launches {used}, "
             f"expected {want_eval}")
    del cpu_model
    state = TrainState.create(model, config, 100, config.get("grad_norm_clip"))
    part = config["optimizer"].get("part", "all")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = finetune.make_finetune_step(model, config, device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 106)
    pd, ld = pts.to(device), labels.to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for _ in range(PART_STEPS):
        t0 = time.perf_counter()
        m = step(state, pd, ld, generator=g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    per_step = launches_a_step(PART_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if per_step != want or not math.isfinite(float(m["loss"])):
        fail(f"zoo: {what}: launches a step {per_step} (expected {want}) or loss "
             f"{float(m['loss'])}")
    after = model.state_dict()
    moved = sorted(k for k in before if not torch.equal(before[k], after[k]))
    if part == "only_new" and (not moved or any("cls" not in k for k in moved)):
        fail(f"zoo: {what}: only_new moved {moved[:8]} (every one must be a cls tensor)")
    groups = sorted({gr["lr_scale"] for gr in state.optimizer.param_groups})
    steady = sorted(times[1:])[(PART_STEPS - 2) // 2]
    busy, _ = profile_step(torch, lambda: step(state, pd, ld, generator=g), card, top=6)
    log(f"  [{card}] {what} (bs {PART_BATCH} of {n}, part {part}, rate scales {groups}): train "
        f"step {steady * 1e3:.2f} ms (median of steps 2-{PART_STEPS}), loss "
        f"{float(m['loss']):.4f}, busy {busy / 1e3:.2f} ms, peak {peak / 2 ** 30:.2f} GiB; "
        f"launches a step {per_step}; {len(moved)} of {len(before)} tensors moved")
    del model, state, step
    torch.cuda.empty_cache()
    return steady, busy, peak


def phase_part_modes(torch, device, card):
    """The fine-tunes of the part modes and PointNet++ (part_mode_run for
    each of PART_RUNS); then the linear probe through the CLI on Synthetic
    clouds (one epoch), after which every tensor of its checkpoint but the
    ``cls`` ones, BatchNorm statistics included, equals the model's initial
    weights."""
    import shutil
    import tempfile

    from point_dae_torch.models import build_model_from_cfg

    records = {what: part_mode_run(torch, what, path, n, want, device, card)
               for what, path, n, want in PART_RUNS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_part_")
    try:
        src = PART_RUNS[0][1]
        cfg = write_config(src, os.path.join(tmp, "cfgs", os.path.basename(src)), RUN_LINEAR_CUT)
        name = os.path.splitext(os.path.basename(src))[0]
        log(f"  {src} through the CLI on Synthetic clouds (64 train, one epoch):")
        out, _, exp, sec = cli_run("linear probe", ["--config", cfg, "--exp_name", "run",
                                                    "--root_folder", tmp, "--finetune_model"],
                                   name, device, range(1), ckpts=("ckpt-last",))
        saved = torch.load(os.path.join(exp, "ckpt-last.pth"), map_location="cpu",
                           weights_only=True)["base_model"]
        fresh = build_model_from_cfg(load_cfg(cfg)["model"], device="cpu", seed=0).state_dict()
        moved = sorted(k for k in fresh if not torch.equal(fresh[k], saved[k]))
        if moved != ["cls.bias", "cls.weight"]:
            fail(f"run linear probe: the tensors that moved are {moved[:8]}, expected the cls "
                 f"Dense's")
        log(f"  [{card}] linear probe through the CLI: {sec:.1f} s, best acc "
            f"{out['best_acc']:.4f}; only cls.weight and cls.bias moved")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for what, (st, bz, pk) in records.items():
        log(f"  [{card}] zoo: {what}: {st * 1e3:.2f} ms a step, busy {bz / 1e3:.2f} ms, "
            f"peak {pk / 2 ** 30:.2f} GiB")


DOWN_MLMAE_CFG = "cfgs/pretrain_PointMlMAE.yaml"
DOWN_MLMAE_STEPS, DOWN_CHECK_BATCH = 5, 8
DOWN_MLMAE_RUN = {"patchify": 1, "gather_rows_small_c": 1, "nn_half_small": 1}
DOWN_ROT_CFGS = (("z2so3", "cfgs/finetune_modelnet_rotation_z2so3_officialmodelnet.yaml"),
                 ("so32so3", "cfgs/finetune_modelnet_rotation_so32so3_officialmodelnet.yaml"))
DOWN_ROT_STEPS = 5
DOWN_CLS_CFG = "cfgs/finetune_modelnet_transferring_features_1k.yaml"
DOWN_RECON = (("flagship", "cfgs/pretrain_synthetic_flagship_cached.yaml", 2e-2),
              ("token_dis", "cfgs/pretrain_synthetic_masksurf_tokendis.yaml", 1e-4))
DOWN_RECON_BATCH = 4
# the share of saliency points whose card gradient may part from the CPU's
# by more than 1e-3 of the largest: a near-tie of a kNN or max pick sends a
# point's gradient along another neighbour (9.16% of the points on these
# clouds, NVIDIA H100 80GB HBM3, 700.00 W), while a wrong backward moves
# nearly every point
DOWN_SALIENCY_MOVED = 0.2


def synthetic_cut(sizes, n_points, classes=40, **over):
    """A config cut whose dataset splits read Synthetic clouds: ``sizes``
    {split: clouds}, each split a seed of its own."""
    return {"dataset": {s: {"_base_": "cfgs/dataset_configs/Synthetic.yaml",
                            "others": {"subset": "train" if s == "train" else "test",
                                       "npoints": 1024, "size": n, "seed": i,
                                       "N_POINTS": n_points, "num_classes": classes}}
                        for i, (s, n) in enumerate(sizes.items())}, **over}


def down_cli(torch, what, cfg, flags, tmp, device):
    """``point_dae_torch.cli.main`` on a written config in process, the
    launch counters zeroed before: (result, LogLines, launches, seconds)."""
    from point_dae_torch import cli
    from point_dae_torch.utils import kernels

    name = os.path.splitext(os.path.basename(cfg))[0]
    lines = LogLines(name)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        out = cli.main(["--config", cfg, "--root_folder", os.path.join(tmp, "exp"),
                        "--exp_name", "run"] + flags, device=device)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - any failure of the run fails the phase
        fail(f"downstream {what}: {type(e).__name__}: {e}")
    finally:
        lines.close()
    return out, lines, launches_a_step(1), time.perf_counter() - t0


def require_launches(what, used, names):
    if any(not used.get(k) for k in names):
        fail(f"downstream {what}: a kernel of the path was never launched: {used}, "
             f"expected {names}")


def down_mlmae(torch, device, card):
    """Point_MlMAE from its shipped config at bs 128 from (128, 8192, 6) raw
    clouds with unit normals: the train-mode losses at batch 8 on the card
    against the CPU (same weights, clouds and draws; 1e-4 relative), then
    DOWN_MLMAE_STEPS steps with every launch counter a step held to
    DOWN_MLMAE_RUN, the step time, a profiled step's busy time and the peak
    memory."""
    from point_dae_torch.engine.pretrain import device_pipeline, init_model

    config = load_cfg(DOWN_MLMAE_CFG)
    g = torch.Generator(device=device).manual_seed(SEED + 110)
    raw = torch.randn((BACKBONE_BATCH, NRAW, 6), generator=g, device=device)
    raw[..., 3:] /= raw[..., 3:].norm(dim=-1, keepdim=True)
    d = config["dataset"]["train"]["others"]
    _, cln = device_pipeline(raw[:DOWN_CHECK_BATCH], d["aug_type"], d["corrupt_type"],
                             d["npoints"], generator=g, device=device)
    cpu_model = init_model(config, seed=SEED + 111, device="cpu")
    model = copy.deepcopy(cpu_model).to(device)
    draws = model.sample_draws(DOWN_CHECK_BATCH, g, device)
    t0 = time.perf_counter()
    with torch.no_grad():
        lg = [float(v) for v in model(cln, cln, draws=draws)]
        lc = [float(v) for v in cpu_model(cln.cpu(), cln.cpu(), draws=on_device(draws, "cpu"))]
    log(f"  Point_MlMAE ({DOWN_MLMAE_CFG}), batch {DOWN_CHECK_BATCH}: card losses {lg[0]:.7f} "
        f"{lg[1]:.7f}; cpu ({time.perf_counter() - t0:.1f} s) {lc[0]:.7f} {lc[1]:.7f}")
    if not all(math.isfinite(v) for v in lg + lc) or min(lc) <= 0 or any(
            abs(a - b) > 1e-4 * abs(b) for a, b in zip(lg, lc)):
        fail(f"downstream MlMAE: card losses {lg} off the CPU's {lc} beyond 1e-4 relative")
    del cpu_model
    steady, first, launches, peak, one_more = run_steps(
        torch, config, raw, device, DOWN_MLMAE_STEPS, SEED + 112, model=model)
    per_step = {k: v / DOWN_MLMAE_STEPS for k, v in launches.items() if v}
    if per_step != DOWN_MLMAE_RUN:
        fail(f"downstream MlMAE: launches a step {per_step}, expected {DOWN_MLMAE_RUN}")
    busy, _ = profile_step(torch, one_more, card, top=6)
    log(f"  [{card}] Point_MlMAE (bs {BACKBONE_BATCH}): step {steady * 1e3:.2f} ms (median of "
        f"steps 2-{DOWN_MLMAE_STEPS}), {BACKBONE_BATCH / steady:.1f} clouds/s, first step "
        f"{first * 1e3:.1f} ms, busy {busy / 1e3:.2f} ms, max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB; launches a step {per_step}")
    del model, one_more
    torch.cuda.empty_cache()
    return per_step


def down_rotation(torch, device, card, tmp):
    """The rotation protocol: a train step of the DGCNN recipe (bs
    DOWN_CHECK_BATCH of 8192 points, so3 angles, the resample's subset and
    the head's dropout masks drawn on the CPU) on the card against the CPU
    (the EdgeConv kernel's plain version there), logits within 1e-3 of the
    largest; DOWN_ROT_STEPS train steps and eval steps at bs 32 timed with
    their launches; then both shipped protocol configs through
    ``--so3_rotation`` on Synthetic clouds of 8192 points (96 train, 64
    test, one epoch): the '[Validation] ... (z2so3)' line and ckpt-last."""
    import numpy as np

    from point_dae_torch.data.corruptions import sample_rotation
    from point_dae_torch.engine import finetune, rotation
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.utils import kernels

    config = load_cfg(DOWN_ROT_CFGS[0][1])
    rng = np.random.default_rng(SEED + 113)
    pts = torch.from_numpy(rng.normal(size=(FT_BATCH, NRAW, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 40, FT_BATCH))
    cpu_model = build_model_from_cfg(config["model"], device="cpu", seed=SEED + 114)
    cpu_model.dgcnn_encoder.impl = "fused_pallas"     # the kernel's plain version on the CPU
    model = copy.deepcopy(cpu_model).to(device)
    model.dgcnn_encoder.impl = "auto"
    gc = torch.Generator().manual_seed(SEED + 115)
    b = DOWN_CHECK_BATCH
    draws = rotation.RotationDraws(
        sample_rotation("so3", b, gc, "cpu"),
        finetune.sample_subset(b, finetune.point_all(1024, NRAW), 1024, gc, "cpu"),
        cpu_model.sample_draws(b, gc, "cpu"))
    logits, clouds = [], []
    t0 = time.perf_counter()
    for m, dev in ((model, device), (cpu_model, "cpu")):
        dd = on_device(draws, dev)
        rp = rotation.rotate_batch(pts[:b].to(dev), "so3", dd.angles)
        clouds.append((rp.cpu(), finetune.fps_resample(rp, 1024, dd.subset).cpu()))
        state = TrainState.create(m, config, 100, config.get("grad_norm_clip"))
        step = rotation.make_rotation_train_step(m, config, "so3", device=dev)
        logits.append(step(state, pts[:b], labels[:b], draws=dd)["logits"].cpu())
    err = float((logits[0] - logits[1]).abs().max() / logits[1].abs().max())
    same = [torch.equal(a, c) for a, c in zip(*clouds)]
    log(f"  rotation train step (so3, bs {b} of {NRAW}): rotated clouds equal {same[0]}, "
        f"resampled clouds equal {same[1]}; logits on the card against the CPU "
        f"({time.perf_counter() - t0:.1f} s) {err:.2e} of the largest")
    if err > 1e-3 or not all(same) or not torch.isfinite(logits[0]).all():
        fail(f"downstream rotation: card logits off the CPU's by {err:.2e} of the largest, "
             f"clouds equal {same}")
    del cpu_model
    pd, ld = pts.to(device), labels.to(device)
    state = TrainState.create(model, config, 100, config.get("grad_norm_clip"))
    step = rotation.make_rotation_train_step(model, config, "so3", device=device)
    eval_step = rotation.make_rotation_eval_step(model, config, "so3", device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 116)
    times = {}
    for what, fn in (("train", lambda: step(state, pd, ld, generator=g)),
                     ("eval", lambda: eval_step(pd, g))):
        fn()
        torch.cuda.synchronize()
        kernels.reset_launches()
        ts = []
        for _ in range(DOWN_ROT_STEPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[what] = (sorted(ts)[DOWN_ROT_STEPS // 2], launches_a_step(DOWN_ROT_STEPS))
        require_launches(f"rotation {what} step", times[what][1],
                         ("fps", "knn_aggregate_fwd") + (("knn_aggregate_bwd_first",)
                                                         if what == "train" else ()))
        log(f"  [{card}] rotation {what} step (bs {FT_BATCH} of {NRAW}): "
            f"{times[what][0] * 1e3:.2f} ms (median of {DOWN_ROT_STEPS}); launches a step "
            f"{times[what][1]}")
    del model, state
    torch.cuda.empty_cache()
    runs = {}
    for mode, src in DOWN_ROT_CFGS:
        cfg = write_config(src, os.path.join(tmp, "cfgs", os.path.basename(src)),
                           synthetic_cut({"train": 96, "val": 64, "test": 64}, NRAW,
                                         max_epoch=0))
        out, lines, used, sec = down_cli(torch, f"--so3_rotation {mode}", cfg,
                                         ["--so3_rotation"], tmp, device)
        val = lines.starting("[Validation] EPOCH: 0 ")
        exp = os.path.join(tmp, "exp", os.path.splitext(os.path.basename(cfg))[0], "cfgs",
                           "run")
        if len(val) != 1 or f"({mode}) best = " not in val[0] or not os.path.exists(
                os.path.join(exp, "ckpt-last.pth")):
            fail(f"downstream --so3_rotation {mode}: validation lines {val}, ckpt-last in "
                 f"{os.listdir(exp) if os.path.isdir(exp) else exp}")
        require_launches(f"--so3_rotation {mode}", used,
                         ("fps", "knn_aggregate_fwd", "knn_aggregate_bwd_first"))
        for m in lines.starting(("[Training]", "[Validation]")):
            log(f"    {m}")
        log(f"  [{card}] --so3_rotation {mode} ({src} on Synthetic clouds): {sec:.1f} s, "
            f"launches {used}")
        runs[mode] = used
    return times, runs


def down_robustness(torch, device, card, tmp, ckpt):
    """The ModelNet-C battery: for one cell per family (level 2), the cell's
    corruption from the same draws (drawn on the CPU) on the card against
    the CPU: the kept index sets identical, the clouds within 1e-5; then
    ``--test_corruption`` through the CLI on a Synthetic test set of 256
    clouds of 1024 points (the generated path): the 1 + 35 cells' lines, the
    seconds of each cell and the launches."""
    from point_dae_torch.engine import robustness

    g = torch.Generator().manual_seed(SEED + 117)
    pts = torch.randn((FT_BATCH, 1024, 3), generator=g)
    for name in robustness.CORRUPTIONS:
        draws = robustness.sample_level_draws(name, 2, FT_BATCH, 1024, g, "cpu")
        dd = on_device(draws, device)
        oc, mc = robustness.level_cloud(pts, name, 2, draws)
        og, mg = robustness.level_cloud(pts.to(device), name, 2, dd)
        fc = robustness._corrupt_level(pts, name, 2, draws)
        fg = robustness._corrupt_level(pts.to(device), name, 2, dd).cpu()
        same = mc is None and mg is None or torch.equal(mc, mg.cpu())
        err = float((fg - fc).abs().max())
        log(f"  {name} level 2 (bs {FT_BATCH} of 1024): index sets "
            f"{'identical' if same else 'DIFFER'}, "
            f"{'' if mc is None else f'{int(mc.sum())} points kept or added, '}"
            f"max |card - cpu| {err:.2e}")
        if not same or err > 1e-5 or not torch.isfinite(fg).all():
            fail(f"downstream robustness: {name} on the card differs from the CPU "
                 f"(sets {same}, {err:.2e})")
    cfg = write_config(DOWN_CLS_CFG, os.path.join(tmp, "cfgs", "corruption.yaml"),
                       synthetic_cut({"train": 32, "val": 32, "test": 256}, 1024))
    out, lines, used, sec = down_cli(
        torch, "--test_corruption", cfg,
        ["--test_corruption", "--ckpts", ckpt, "--modelnet_c_root", os.path.join(tmp, "none")],
        tmp, device)
    timed = list(zip(lines.times, lines.lines))
    cells = [(t, m) for t, m in timed if m.startswith(("{'OA'", "{'acc'"))]
    if len(cells) != 36 or not all(math.isfinite(out[k]) for k in ("mOA", "mCE", "RmCE")):
        fail(f"downstream --test_corruption: {len(cells)} cell lines, results {out}")
    start = [t for t, m in timed if m.startswith("[Corruption]")][0]
    secs = [b[0] - a for a, b in zip([start] + [t for t, _ in cells[:-1]], cells)]
    require_launches("--test_corruption", used, ("fps", "knn_aggregate_fwd", "key_gather"))
    log(f"  [{card}] --test_corruption ({DOWN_CLS_CFG}, 256 Synthetic clouds of 1024 points): "
        f"{sec:.1f} s; clean cell {secs[0]:.3f} s; per family the 5 levels' seconds: " + "; ".join(
            f"{name} " + " ".join(f"{s:.3f}" for s in secs[1 + 5 * i:6 + 5 * i])
            for i, name in enumerate(robustness.CORRUPTIONS)))
    log(f"    {lines.lines[-1]}; launches {used}")
    return used, sec


def down_saliency(torch, device, card, tmp, ckpt, cpu_model):
    """``--vis_saliency`` through the CLI on the classifier config (Synthetic
    test clouds of 8192 points, cut to 1024): 8 ``.npz`` files, then one
    file's gradients against the EdgeConv kernels' plain versions on the
    card within 1e-3 of the largest, its eval logits against the CPU's
    within 1e-3 of the largest (as the fine-tune checks hold them), and its
    gradients against the CPU's: at most DOWN_SALIENCY_MOVED of the points
    off by more than 1e-3 of the largest."""
    import numpy as np

    from point_dae_torch.engine.saliency import make_saliency_fn

    cfg = write_config(DOWN_CLS_CFG, os.path.join(tmp, "cfgs", "saliency.yaml"),
                       synthetic_cut({"train": 16, "val": 16, "test": 64}, NRAW))
    out_dir, lines, used, sec = down_cli(torch, "--vis_saliency", cfg,
                                         ["--vis_saliency", "--ckpts", ckpt], tmp, device)
    files = sorted(os.listdir(out_dir))
    if files != [f"saliency_{i:03d}.npz" for i in range(8)]:
        fail(f"downstream --vis_saliency: files {files}")
    z = np.load(os.path.join(out_dir, files[3]))
    t0 = time.perf_counter()
    pts, labels = torch.from_numpy(z["points"]), torch.from_numpy(z["labels"])
    want = make_saliency_fn(cpu_model, device="cpu")(pts, labels).numpy()
    with torch.no_grad():
        lc = cpu_model(pts)
    card_model = copy.deepcopy(cpu_model).to(device)
    card_model.dgcnn_encoder.impl = "auto"
    with torch.no_grad():
        lg = card_model(pts.to(device)).cpu()
    x = pts.to(device).requires_grad_(True)       # the EdgeConv kernels' plain versions
    logits = card_model.cls_head_finetune(dgcnn_feature_plain(torch, card_model.dgcnn_encoder, x))
    (plain,) = torch.autograd.grad(logits.gather(1, labels.to(device)[:, None]).sum(), x)
    plain = plain.cpu().numpy()
    del card_model, x, logits
    err_plain = float(np.abs(z["grads"] - plain).max() / np.abs(plain).max())
    err_logits = float((lg - lc).abs().max() / lc.abs().max())
    top = np.abs(want).max()
    err = float(np.abs(z["grads"] - want).max() / top)
    moved = float((np.abs(z["grads"] - want).max(-1) > 1e-3 * top).mean())
    require_launches("--vis_saliency", used, ("knn_aggregate_fwd", "knn_aggregate_bwd_first"))
    log(f"  [{card}] --vis_saliency: {sec:.1f} s for 8 batches of 8; batch 3's gradients "
        f"{z['grads'].shape} against the EdgeConv kernels' plain versions on the card "
        f"{err_plain:.2e} of the largest; logits against the CPU {err_logits:.2e} of the "
        f"largest; gradients against the CPU ({time.perf_counter() - t0:.1f} s) {err:.2e} "
        f"of the largest, {100 * moved:.2f}% of the points off by more than 1e-3 of it; "
        f"launches {used}")
    # a kNN or a max sends a point's gradient along one pick: where f32
    # products round apart on the two devices a near-tie picks another
    # neighbour (on these clouds the CPU's reference and fused layouts part
    # on 7% of the points), so the gradients are held to the kernels' plain
    # versions on the card, and to the CPU's on all but the near-tie share
    if err_plain > 1e-3 or err_logits > 1e-3 or moved > DOWN_SALIENCY_MOVED \
            or not np.isfinite(z["grads"]).all():
        fail(f"downstream --vis_saliency: card gradients off the plain versions by "
             f"{err_plain:.2e}, logits off the CPU's by {err_logits:.2e}, gradients off the "
             f"CPU's on {100 * moved:.2f}% of the points (limit "
             f"{100 * DOWN_SALIENCY_MOVED:.0f}%)")
    return used, sec


def down_reconstruct(torch, device, card, tmp):
    """``reconstruct`` of each of DOWN_RECON: at batch DOWN_RECON_BATCH on the
    card against the CPU (same weights, clouds and draws; eval mode): every
    output within the stated share of its largest (2% for the bf16
    flagship, 1e-4 for f32 token_dis), the mask and token ids equal; one
    call at the config's total_bs timed with its launches; then ``--test``
    through the CLI from a checkpoint of those weights on Synthetic clouds:
    16 samples, each with its renders (``.png.npy`` where matplotlib is
    missing) and ``.npz``; last ``visualize_corruptions`` on the card: the
    clean render and one a corruption."""
    import numpy as np

    from point_dae_torch.engine.pretrain import init_model
    from point_dae_torch.engine.visualization import visualize_corruptions
    from point_dae_torch.utils import kernels

    out = {}
    for what, src, tol in DOWN_RECON:
        config = load_cfg(src)
        cpu_model = init_model(config, seed=SEED + 118, device="cpu")
        if hasattr(cpu_model, "build_reconstruct"):
            cpu_model.build_reconstruct(torch.Generator().manual_seed(SEED + 119))
        cpu_model.eval()
        model = copy.deepcopy(cpu_model).to(device).eval()
        gc = torch.Generator().manual_seed(SEED + 120)
        b = DOWN_RECON_BATCH
        clean = torch.randn((b, 1024, 6), generator=gc)
        clean[..., 3:] /= clean[..., 3:].norm(dim=-1, keepdim=True)
        draws = cpu_model.sample_draws(b, gc, "cpu")
        t0 = time.perf_counter()
        with torch.no_grad():
            rg = [v.cpu() for v in model.reconstruct(clean.to(device), draws=on_device(
                draws, device))]
            rc = cpu_model.reconstruct(clean, draws=draws)
        errs = []
        for a, w in zip(rg, rc):
            if w.dtype in (torch.bool, torch.int64):
                errs.append(0.0 if torch.equal(a, w) else math.inf)
            else:
                errs.append(float((a.float() - w.float()).abs().max() / w.float().abs().max()))
        log(f"  {what} reconstruct ({src}), batch {b}: card against the CPU "
            f"({time.perf_counter() - t0:.1f} s), each output's max |card - cpu| / max |cpu| "
            f"{['%.2e' % e for e in errs]}")
        if max(errs) > tol:
            fail(f"downstream {what} reconstruct: card off the CPU beyond {tol}: {errs}")
        tb = int(config["total_bs"])
        big = torch.randn((tb, 1024, 6), generator=gc).to(device)
        gg = torch.Generator(device=device).manual_seed(SEED + 121)
        with torch.no_grad():
            model.reconstruct(big, generator=gg)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            model.reconstruct(big, generator=gg)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        big_used = launches_a_step(1)
        ckpt = os.path.join(tmp, f"{what}.pth")
        torch.save({"base_model": cpu_model.state_dict()}, ckpt)
        del cpu_model, model, big
        torch.cuda.empty_cache()
        cfg = write_config(src, os.path.join(tmp, "cfgs", os.path.basename(src)),
                           synthetic_cut({"test": 20}, 1024, classes=15))
        vis, lines, used, sec = down_cli(torch, f"--test {what}", cfg, ["--test", "--ckpts", ckpt],
                                         tmp, device)
        files = os.listdir(vis)
        stems = {f[:-4] for f in files if f.endswith(".npz")}
        views = all(any(f.startswith(f"{s}_{v}.png") for f in files)
                    for s in stems for v in ("gt", "coarse", "rebuild"))
        if len(stems) != 16 or not views or lines.lines[-1] != f"[Vis] saved 16 samples to {vis}":
            fail(f"downstream --test {what}: {len(stems)} samples, every view {views}, last line "
                 f"{lines.lines[-1]}")
        z = np.load(os.path.join(vis, sorted(stems)[0] + ".npz"))
        log(f"  [{card}] {what} reconstruct at bs {tb}: {ms:.2f} ms (one call), launches "
            f"{big_used}; --test through the CLI: {sec:.1f} s for 16 samples, launches {used}, "
            f"rebuild {z['rebuild'].shape}, render files "
            f"{sorted({f.split('.', 1)[1] for f in files})}")
        out[what] = (used, big_used)
    t0 = time.perf_counter()
    vdir = visualize_corruptions(os.path.join(tmp, "corruptions"), device=device)
    stems = sorted(f.split(".")[0] for f in os.listdir(vdir))
    want = sorted(("clean", "affine_r3", "dropout_local", "add_global", "add_local", "jitter",
                   "nonuniform_density"))
    if stems != want:
        fail(f"downstream visualize_corruptions: renders {stems}, expected {want}")
    log(f"  [{card}] visualize_corruptions on the card: {time.perf_counter() - t0:.1f} s, "
        f"{len(stems)} renders")
    return out


def phase_downstream(torch, device, card):
    """The downstream modes and Point_MlMAE (down_mlmae, down_rotation,
    down_robustness, down_saliency, down_reconstruct); each kernel of the
    slice's paths must launch on its path."""
    import shutil
    import tempfile

    from point_dae_torch.models import build_model_from_cfg

    stamps = [time.perf_counter()]
    mlmae = down_mlmae(torch, device, card)
    stamps.append(time.perf_counter())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_down_")
    try:
        rot, rot_runs = down_rotation(torch, device, card, tmp)
        stamps.append(time.perf_counter())
        cls = build_model_from_cfg(load_cfg(DOWN_CLS_CFG)["model"], device="cpu", seed=SEED + 122)
        gm = torch.Generator().manual_seed(SEED + 123)
        with torch.no_grad():     # running statistics off (0, 1), as a trained model's
            for n, buf in cls.named_buffers():
                if n.endswith("running_mean"):
                    buf.copy_(0.1 * torch.randn(buf.shape, generator=gm))
                elif n.endswith("running_var"):
                    buf.copy_(0.5 + torch.rand(buf.shape, generator=gm))
        ckpt = os.path.join(tmp, "classifier.pth")
        torch.save({"base_model": cls.state_dict()}, ckpt)
        cls.dgcnn_encoder.impl = "fused_pallas"       # the kernel's plain version on the CPU
        corrupt, _ = down_robustness(torch, device, card, tmp, ckpt)
        stamps.append(time.perf_counter())
        saliency, _ = down_saliency(torch, device, card, tmp, ckpt, cls.eval())
        stamps.append(time.perf_counter())
        recon = down_reconstruct(torch, device, card, tmp)
        stamps.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    flag = recon["flagship"]
    paths = {   # kernel: its launches on each new path
        "fps": (rot["train"][1].get("fps"), rot["eval"][1].get("fps"), corrupt.get("fps")),
        "knn_aggregate_fwd": (rot_runs["z2so3"].get("knn_aggregate_fwd"),
                              corrupt.get("knn_aggregate_fwd"),
                              saliency.get("knn_aggregate_fwd")),
        "knn_aggregate_bwd_first": (rot_runs["so32so3"].get("knn_aggregate_bwd_first"),
                                    saliency.get("knn_aggregate_bwd_first")),
        "key_gather": (corrupt.get("key_gather"),),
        "patchify": (mlmae.get("patchify"), flag[0].get("patchify"),
                     recon["token_dis"][0].get("patchify")),
        "gather_rows_small_c": (mlmae.get("gather_rows_small_c"),
                                flag[1].get("gather_rows_small_c")),
        "nn_half_small": (mlmae.get("nn_half_small"),),
        "mlp_ln_fwd": (flag[0].get("mlp_ln_fwd"), flag[1].get("mlp_ln_fwd")),
        "attention_fwd": (flag[0].get("attention_fwd"), flag[1].get("attention_fwd")),
        "folding_fwd": (flag[0].get("folding_fwd"), flag[1].get("folding_fwd"))}
    log(f"  downstream launches by kernel on its new paths: {paths}")
    for k, v in paths.items():
        if not all(v):
            fail(f"downstream: {k} was not launched on one of its new paths: {v}")
    names = ("MlMAE", "rotation", "robustness", "saliency", "reconstruction")
    log(f"  [{card}] downstream seconds: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(names, stamps, stamps[1:])))


CNN_CFG = "cfgs/pretrain_PointCAE_affine_r3.yaml"    # model.NAME replaced in memory
CNN_BATCH, CNN_STEPS = 128, 3
_CNN_DG = {"knn_aggregate_fwd": 4, "knn_aggregate_bwd_first": 4}
_CNN_DGPS = {"knn": 3, "gather_rows_small_c": 1, "scatter_rows_add": 2}
_CNN_PN2 = {"fps": 2, "gather_rows_small_c": 2, "scatter_rows_add": 1}
_CNN_MA2E = {"fps": 2, "patchify": 1, "gather_rows_small_c": 3, "scatter_rows_add": 1}
_CNN_PCN = {"nn_half_tiled": 2}                       # coarse and fine, a launch each
_CNN_FC = {"nn_half_tiled": 1}
CNN_RUNS = (   # (class, launches a step, checked on the card against the CPU)
    ("Point_CAE_DGCNN", {**_CNN_DG, **_CNN_PCN}, True),
    ("Point_CAE_DGCNN_proj", {**_CNN_DG, **_CNN_PCN}, False),
    ("Point_CAE_DGCNN_FoldOnly", {**_CNN_DG, **_CNN_FC}, True),
    ("Point_AE_Corruption_DGCNN", {**_CNN_DG, **_CNN_FC}, False),
    ("Point_CAE_DGCNN_PartSeg", {**_CNN_DGPS, **_CNN_PCN}, False),
    ("Point_CAE_DGCNN_proj_PartSeg", {**_CNN_DGPS, **_CNN_PCN}, True),
    ("Point_CAE_PointNetv2", {**_CNN_PN2, **_CNN_PCN}, False),
    ("Point_CAE_PointNetv2_Proj", {**_CNN_PN2, **_CNN_PCN}, True),
    ("Point_CAE_PointNetv2_FCOnly", {**_CNN_PN2, **_CNN_FC}, False),
    ("Point_MA2E_PointNetv2", {**_CNN_MA2E, "nn_half_small": 1}, True),
    ("Point_MA2E_PointNetv2_local_only", {**_CNN_MA2E, "nn_half_small": 1}, False),
    ("Point_MA2E_PointNetv2_global_only", _CNN_MA2E, False),   # no folding head, no patch chamfer
    ("Point_CAE_PointNet", _CNN_FC, True),
    ("Point_CAE_PointNet_NoT", _CNN_FC, False),
    ("Point_CAE_PointNetNoT_PartSeg", _CNN_FC, True))
CNN_GATE_BATCHES = (8, 16, 32, 64, 128)
CNN_FT_CFG = "cfgs/finetune_modelnet_transferring_features_1k.yaml"   # NAME: PointNet
CNN_FT_BATCH = 32
CNN_RUN_CUT = {"max_epoch": 0, "loss_type": "xyznormal",     # one epoch of 8 steps
               "model": {"NAME": "Point_CAE_DGCNN"}}


def cnn_kernels(torch, raw, device, card):
    """Each kernel of the slice's paths at its new shapes against its plain
    version, bit for bit, with its time a call: the tiled chamfer at (128,
    16384, 3) x (128, 1024, 3), both directions in one launch (the PCN
    decoders' fine points against the clean cloud), beside its plain halves
    (taken 16 clouds at a time), torch.cdist + min and its bound; fps at
    PointNet++'s (128, 1024) -> 512 and (128, 512) -> 128; the small-C
    gather of those ball groups; the scatter-add of sa2's feature gather's
    backward ((128, 8192) rows of 128 into 512) and of the DGCNN
    part-segmentation encoder's stage 2-3 edge gathers ((128, 20480) rows
    of 64 into 1024), against the plain version on the CPU; the patch
    chamfer over MA2E's 8192 pairs of 36 and 32 points."""
    from point_dae_torch.losses import chamfer
    from point_dae_torch.ops import fps, gather
    from point_dae_torch.ops.geometry import ball_query, gather_points, knn

    g = torch.Generator(device=device).manual_seed(SEED + 130)
    B = CNN_BATCH
    clean = raw[:, :1024, :3].contiguous()
    # -- the asymmetric tiled chamfer: 16 fine points around each clean one
    fine = (clean.repeat_interleave(16, 1)
            + 0.05 * torch.randn((B, 16384, 3), generator=g, device=device)).contiguous()
    if not (chamfer.use_tiled_kernel(fine, 1024) and chamfer.use_tiled_kernel(clean, 16384)):
        fail("cnn: the tiled chamfer's gate is closed at (16384, 1024)")
    got = chamfer.nn_half_tiled_pair(fine, clean)
    for s in range(0, B, 16):
        want = (chamfer.nn_half_tiled_plain(fine[s:s + 16], clean[s:s + 16])
                + chamfer.nn_half_tiled_plain(clean[s:s + 16], fine[s:s + 16]))
        kernel_vs_plain(torch, "cnn: the tiled chamfer (128, 16384) x (128, 1024)",
                        [o[s:s + 16] for o in got], want)
    del got, want
    ms = cuda_ms(lambda: chamfer.nn_half_tiled_pair(fine, clean), 20)

    def plain_halves():
        for s in range(0, B, 16):
            chamfer.nn_half_tiled_plain(fine[s:s + 16], clean[s:s + 16])
            chamfer.nn_half_tiled_plain(clean[s:s + 16], fine[s:s + 16])

    def lib_chamfer():
        d = torch.cdist(fine, clean) ** 2
        return d.min(2).values, d.min(1).values

    plain = cuda_ms(plain_halves, 2)
    lib = cuda_ms(lib_chamfer, 5)
    torch.cuda.empty_cache()
    pairs = 2 * B * 16384 * 1024
    bound = bound_ms(B * (16384 + 1024) * (12 + 8), pairs * 9, F32_FLOPS)
    log(f"  [{card}] tiled chamfer (128, 16384, 3) x (128, 1024, 3), both directions, one "
        f"launch: {ms:.4f} ms a call, bit for bit with the plain halves; plain halves "
        f"{plain:.4f} ms; torch.cdist + min {lib:.4f} ms; bound {bound[0]:.4f} by {bound[1]}")
    del fine
    # -- PointNet++'s two samplings, ball groups and sa2's feature scatter
    c512_idx = fps.furthest_point_sample(clean, 512)
    c512 = gather_points(clean, c512_idx)
    c128 = gather_points(c512, fps.furthest_point_sample(c512, 128))
    for src, n in ((clean, 512), (c512, 128)):
        if not fps.use_fps_kernel("cuda", src.shape[1]):
            fail(f"cnn: the fps gate is closed at {tuple(src.shape)}")
        kernel_vs_plain(torch, f"cnn: fps {tuple(src.shape)} -> {n}",
                        [fps.furthest_point_sample(src, n)],
                        [fps.furthest_point_sample_plain(src, n)])
        log(f"  [{card}] fps {tuple(src.shape)} -> {n}: "
            f"{cuda_ms(lambda: fps.furthest_point_sample(src, n), 10):.4f} ms a call, bit for bit")
    groups = (("sa1's balls (128, 1024, 3) by 512 x 32", clean, ball_query(0.2, 32, clean, c512)),
              ("sa2's balls (128, 512, 3) by 128 x 64", c512, ball_query(0.4, 64, c512, c128)))
    for what, x, nidx in groups:
        idx = nidx.reshape(B, -1)
        if not gather.use_small_c_kernel(x, idx.shape[1]):
            fail(f"cnn: the small-C gate is closed at {what}")
        kernel_vs_plain(torch, f"cnn: gather_rows_small_c {what}",
                        [gather.gather_rows_small_c(x, idx)],
                        [gather.gather_rows_small_c_plain(x, idx)])
        log(f"  [{card}] gather_rows_small_c {what}: "
            f"{cuda_ms(lambda: gather.gather_rows_small_c(x, idx), 20):.4f} ms a call, "
            f"bit for bit")
    _, knn_idx = knn(clean, clean, 20)
    scatters = (("sa2's feature gather's backward, (128, 8192) rows of 128 into 512",
                 groups[1][2].reshape(B, -1), 512, 128),
                ("the part-seg encoder's edge gather's backward, (128, 20480) rows of 64 "
                 "into 1024", knn_idx.reshape(B, -1), 1024, 64))
    for what, idx, n, c in scatters:
        if not gather.use_scatter_kernel("cuda", B, idx.shape[1], n, c):
            fail(f"cnn: the scatter gate is closed at {what}")
        grad = torch.randn((B, idx.shape[1], c), generator=g, device=device)
        got = gather.scatter_rows_add(idx, grad, n)
        if not torch.equal(got.cpu(), gather.scatter_rows_add_plain(idx.cpu(), grad.cpu(), n)):
            fail(f"cnn: scatter_rows_add at {what} differs from the plain version")
        log(f"  [{card}] scatter_rows_add {what}: "
            f"{cuda_ms(lambda: gather.scatter_rows_add(idx, grad, n), 20):.4f} ms a call, bit "
            f"for bit with the plain version on the CPU")
    # -- MA2E's patch chamfer: 36 folded points against each 32-point patch
    x = (0.2 * torch.randn((B * 64, 36, 3), generator=g, device=device)).contiguous()
    y = (0.2 * torch.randn((B * 64, 32, 3), generator=g, device=device)).contiguous()
    if not chamfer.use_small_kernel(x, 32):
        fail("cnn: the patch chamfer's gate is closed at MA2E's patches")
    kernel_vs_plain(torch, "cnn: the patch chamfer (8192, 36, 32)",
                    chamfer.nn_half_small_pair(x, y),
                    chamfer.nn_half_small_plain(x, y) + chamfer.nn_half_small_plain(y, x))
    log(f"  [{card}] patch chamfer 8192 pairs of 36 and 32 points, both directions: "
        f"{cuda_ms(lambda: chamfer.nn_half_small_pair(x, y), 20):.4f} ms a call, bit for bit "
        f"with the plain halves")


def cnn_config(name):
    config = load_cfg(CNN_CFG)
    config["model"]["NAME"] = name
    return config


def cnn_gate_batch(torch, model, cor, cln, want):
    """The smallest of CNN_GATE_BATCHES at which a train-mode forward and
    backward of (a copy of) ``model`` launch every kernel of ``want`` as
    often as a step at batch 128 does."""
    from point_dae_torch.utils import kernels

    for b in CNN_GATE_BATCHES:
        m = copy.deepcopy(model).train()
        kernels.reset_launches()
        out = m(cor[:b], cln[:b])
        (out[0] + out[1]).backward()
        torch.cuda.synchronize()
        if launches_a_step(1) == want:
            return b
    fail(f"cnn: no batch of {CNN_GATE_BATCHES} launches {want}")


@contextlib.contextmanager
def neighbour_picks(torch, picks, replay):
    """Record (``replay`` False) every neighbour and sample choice of the
    slice's models on the card (EdgeConv's kNN in the fused kernel or the
    kNN kernel, the ball queries, FPS, patchify's centres and members,
    ``three_nn``'s neighbours and distances) into ``picks``, or take them
    back from ``picks`` in the same order on the CPU (``replay`` True)."""
    from point_dae_torch.models import dae_pointnet2 as pn2
    from point_dae_torch.models import dgcnn as dg
    from point_dae_torch.ops import geometry as geo

    # (module, function, which of its outputs are picks: None for the output itself)
    sites = ((dg, "knn_aggregate", (4,)), (dg, "knn", (1,)), (pn2, "ball_query", None),
             (pn2, "furthest_point_sample", None), (pn2, "three_nn", (0, 1)),
             (geo, "fps_knn", (0, 2)))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    queue = iter(picks)

    def recorder(fn, which):
        def call(*args):
            out = fn(*args)
            chosen = (out,) if which is None else tuple(out[i] for i in which)
            picks.extend(t.detach().cpu() for t in chosen)
            return out
        return call

    def knn(q, d, k):                       # EdgeConv's: the fused kernel's or the kNN kernel's
        return None, next(queue)

    def fps_knn(xyz, groups, size):
        fps_idx, idx = next(queue), next(queue)
        return fps_idx, geo.gather_points(xyz, fps_idx), idx

    if replay:
        dg.knn, geo.fps_knn = knn, fps_knn
        pn2.ball_query = lambda radius, k, xyz, new_xyz: next(queue)
        pn2.furthest_point_sample = lambda xyz, n: next(queue)
        pn2.three_nn = lambda unknown, known: (next(queue), next(queue))
    else:
        for mod, name, which in sites:
            setattr(mod, name, recorder(getattr(mod, name), which))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    if replay and next(queue, None) is not None:
        fail("cnn: the CPU run took fewer neighbour picks than the card's")


def cnn_check(torch, name, config, raw, want, device, g):
    """The train-mode losses at the smallest batch at which every gate of
    the model opens, on the card against the CPU with the same weights and
    clouds, within 1e-4 relative. The CPU takes the card's neighbour picks
    (neighbour_picks; a DGCNN encoder's CPU copy the fused kernel's plain
    version), so the check is of the arithmetic: where the card's f32
    distances and the CPU's settle a near-tie apart, one EdgeConv
    neighbour moves the loss by about 3e-5 (a 1e-7 perturbation of the
    input on the CPU moved it so)."""
    from point_dae_torch.engine.pretrain import device_pipeline, init_model

    d = config["dataset"]["train"]["others"]
    cor, cln = device_pipeline(raw, d["aug_type"], d["corrupt_type"], d["npoints"],
                               generator=g, device=device)
    cpu_model = init_model(config, seed=SEED + 131, device="cpu")
    model = copy.deepcopy(cpu_model).to(device)
    b = cnn_gate_batch(torch, model, cor, cln, want)
    enc = getattr(cpu_model, "dgcnn_encoder", None)
    if hasattr(enc, "impl"):
        enc.impl = "fused_pallas"
    t0 = time.perf_counter()
    picks = []
    with torch.no_grad():
        with neighbour_picks(torch, picks, False):
            lg = [float(v) for v in model.train()(cor[:b], cln[:b])]
        with neighbour_picks(torch, picks, True):
            lc = [float(v) for v in cpu_model.train()(cor[:b].cpu(), cln[:b].cpu())]
    err = max(abs(a - c) / max(abs(c), 1e-12) for a, c in zip(lg, lc) if c or a)
    log(f"  {name} at batch {b} (the smallest at which every gate opens): card losses "
        f"{lg[0]:.7f} {lg[1]:.7f}; cpu ({time.perf_counter() - t0:.1f} s, the card's "
        f"{len(picks)} neighbour picks) {lc[0]:.7f} {lc[1]:.7f}; {err:.2e} relative")
    if not all(math.isfinite(v) for v in lg + lc) or err > 1e-4:
        fail(f"cnn: {name}: card losses {lg} off the CPU's {lc} beyond 1e-4 relative")
    return b, err


def cnn_downstream(torch, device, card):
    """PointNet's fine-tune train step and eval step through fps_resample
    (the shipped ModelNet recipe with NAME replaced, bs 32 of 8192 points),
    its eval logits on the card against the CPU; a feature-extraction batch
    of ``PointNet_feat`` (FPS 2048 -> 1024, then the extractor) against the
    CPU; ``FeaturePropagation``'s forward and backward at PointNet++'s sa2
    -> sa1 shapes on the card against the CPU."""
    import numpy as np

    from point_dae_torch.engine import finetune
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import build_model_from_cfg
    from point_dae_torch.models.dae_pointnet2 import FeaturePropagation
    from point_dae_torch.ops.geometry import furthest_point_sample, gather_points
    from point_dae_torch.utils import kernels

    config = load_cfg(CNN_FT_CFG)
    config["model"]["NAME"] = "PointNet"
    rng = np.random.default_rng(SEED + 132)
    pts = torch.from_numpy(rng.normal(size=(CNN_FT_BATCH, NRAW, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, config["model"]["cls_dim"], CNN_FT_BATCH))
    cpu_model = build_model_from_cfg(config["model"], device="cpu", seed=SEED + 133)
    model = copy.deepcopy(cpu_model).to(device)
    state = TrainState.create(model, config, 100, config.get("grad_norm_clip"))
    step = finetune.make_finetune_step(model, config, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 134)
    pd, ld = pts.to(device), labels.to(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = step(state, pd, ld, generator=gen)
    torch.cuda.synchronize()
    train_ms, train_used = (time.perf_counter() - t0) * 1e3, launches_a_step(1)
    eval_step = finetune.make_eval_step(model, config, device=device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    lg = eval_step(pd)
    torch.cuda.synchronize()
    eval_ms, eval_used = (time.perf_counter() - t0) * 1e3, launches_a_step(1)
    moved = copy.deepcopy(model).cpu()
    lc = finetune.make_eval_step(moved, config, device="cpu")(pts)
    err = rel_err(lg.cpu(), lc)
    log(f"  [{card}] PointNet ({CNN_FT_CFG}, bs {CNN_FT_BATCH} of {NRAW}): train step "
        f"{train_ms:.2f} ms (the first), loss {float(m['loss']):.4f}, launches {train_used}; "
        f"eval step {eval_ms:.2f} ms, launches {eval_used}; eval logits {err:.2e} of the "
        f"largest off the CPU's")
    if train_used != {"fps": 1} or eval_used != {"fps": 1} or err > 1e-4 \
            or not math.isfinite(float(m["loss"])):
        fail(f"cnn: PointNet fine-tune: launches {train_used} / {eval_used} (expected fps 1 "
             f"each), eval logits {err:.2e} off the CPU's, loss {float(m['loss'])}")
    del model, state, step, cpu_model, moved

    feat_cfg = {"NAME": "PointNet_feat"}
    cpu_feat = build_model_from_cfg(feat_cfg, device="cpu", seed=SEED + 135).eval()
    feat = copy.deepcopy(cpu_feat).to(device).eval()
    clouds = torch.from_numpy(rng.normal(size=(64, 2048, 3)).astype(np.float32))
    cd = clouds.to(device)
    kernels.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        fg = feat(gather_points(cd, furthest_point_sample(cd, 1024)))
        torch.cuda.synchronize()
        feat_ms, feat_used = (time.perf_counter() - t0) * 1e3, launches_a_step(1)
        fc = cpu_feat(gather_points(clouds, furthest_point_sample(clouds, 1024)))
    err = rel_err(fg.cpu(), fc)
    log(f"  [{card}] PointNet_feat extraction batch (64, 2048) -> 1024: {feat_ms:.2f} ms, "
        f"launches {feat_used}; features {err:.2e} of the largest off the CPU's")
    if feat_used != {"fps": 1} or err > 1e-4:
        fail(f"cnn: PointNet_feat: launches {feat_used}, features {err:.2e} off the CPU's")

    # sa2 -> sa1 as PointNet++ has it: the known points an FPS subset of the
    # query points (three_nn's picks and distances replayed on the CPU: a
    # query near a known point weighs it by 1 / (d + 1e-8), so a rounding of
    # d moves the interpolation, 17% of the output on the CPU for a 1e-7
    # perturbation of uniform random points)
    fp_cpu = FeaturePropagation(128 + 256, (256, 256), torch.Generator().manual_seed(5))
    fp = copy.deepcopy(fp_cpu).to(device)
    xyz1 = torch.from_numpy(rng.uniform(-1, 1, (CNN_BATCH, 512, 3)).astype(np.float32))
    xyz2 = gather_points(xyz1, furthest_point_sample(xyz1, 128))
    f1 = torch.from_numpy(rng.normal(size=(CNN_BATCH, 512, 128)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(CNN_BATCH, 128, 256)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(CNN_BATCH, 512, 256)).astype(np.float32))
    outs, picks = [], []
    for replay, mod, dev in ((False, fp, device), (True, fp_cpu, "cpu")):
        a, b = f1.to(dev).clone().requires_grad_(), f2.to(dev).clone().requires_grad_()
        kernels.reset_launches()
        with neighbour_picks(torch, picks, replay):
            out = mod.train()(xyz1.to(dev), xyz2.to(dev), a, b)
        (out * cot.to(dev)).sum().backward()
        if not replay:
            torch.cuda.synchronize()
            used = launches_a_step(1)
        outs.append([out.detach().cpu(), a.grad.cpu(), b.grad.cpu()]
                    + [p.grad.cpu() for p in mod.parameters()])
    # the output within 1e-4 of its largest; each gradient (both feature
    # inputs, every parameter) within 1e-3 of its norm: on the CPU alone an
    # f32 run of these shapes parts from an f64 one by 2.5e-4 to 3e-4 of each
    # gradient's norm (ReLU gates within rounding of zero among 16.7 M
    # pre-activations send single elements' gradients apart, up to 2.9e-2 of
    # the largest), and by 8.6e-7 of the output's largest
    err_out = rel_err(outs[0][0], outs[1][0])
    errs = [float((x - y).norm() / y.norm()) for x, y in zip(outs[0][1:], outs[1][1:])]
    log(f"  [{card}] FeaturePropagation (128, 128 -> 512, 128 + 256 -> 256 -> 256), forward "
        f"and backward: launches {used}; output {err_out:.2e} of its largest off the CPU's, "
        f"gradients at most {max(errs):.2e} of their norms (the card's three_nn picks)")
    if used != {"scatter_rows_add": 1} or err_out > 1e-4 or max(errs) > 1e-3:
        fail(f"cnn: FeaturePropagation: launches {used}, output {err_out:.2e}, gradients "
             f"{errs}")


def phase_cnn_zoo(torch, device, card):
    """The PointNet, PointNet++ and DGCNN classes of the slice: the kernels
    at the paths' new shapes (cnn_kernels); every pretrain class of
    CNN_RUNS at full width from (128, 8192, 6) raw clouds through
    ``device_pipeline`` (``cfgs/pretrain_PointCAE_affine_r3.yaml`` with
    model.NAME replaced): one class of each encoder and decoder pair on the
    card against the CPU (cnn_check), CNN_STEPS steps of each with its
    launches a step held to CNN_RUNS, the median step time, a profiled
    step's busy time and the peak memory; PointNet's fine-tune steps, a
    ``_feat`` extraction batch and ``FeaturePropagation`` (cnn_downstream);
    ``main_torch.py``'s CLI pretraining ``Point_CAE_DGCNN`` for one epoch on
    Synthetic clouds (``cfgs/pretrain_synthetic_dgcnn.yaml`` with NAME
    replaced), the SVM probe through ``encode``."""
    import shutil
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    raw = torch.from_numpy(np.random.default_rng(SEED + 136).normal(
        size=(CNN_BATCH, NRAW, 6)).astype(np.float32)).to(device)
    raw[..., 3:] /= raw[..., 3:].norm(dim=-1, keepdim=True)
    cnn_kernels(torch, raw, device, card)
    torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(SEED + 137)
    records = {}
    for name, want, checked in CNN_RUNS:
        config = cnn_config(name)
        check = cnn_check(torch, name, config, raw, want, device, g) if checked else None
        steady, first, launches, peak, one_more = run_steps(torch, config, raw, device,
                                                            CNN_STEPS, SEED + 138)
        per_step = {k: v / CNN_STEPS for k, v in launches.items() if v}
        if per_step != want:
            fail(f"cnn: {name}: launches a step {per_step}, expected {want}")
        busy, _ = profile_step(torch, one_more, card, top=4)
        records[name] = (steady, busy, peak, check)
        log(f"  [{card}] {name}: step {steady * 1e3:.2f} ms (median of steps 2-{CNN_STEPS}), "
            f"first {first * 1e3:.1f} ms, busy {busy / 1e3:.2f} ms, max_memory_allocated "
            f"{peak / 2 ** 30:.2f} GiB; launches a step {per_step}")
        del one_more
        torch.cuda.empty_cache()
    del raw
    torch.cuda.empty_cache()
    cnn_downstream(torch, device, card)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cnn_")
    try:
        cfg = write_config(RUN_DGCNN_CFG, os.path.join(tmp, "cfgs", "pretrain_cnn_pcn.yaml"),
                           CNN_RUN_CUT)
        log(f"  {RUN_DGCNN_CFG} with NAME Point_CAE_DGCNN through the CLI (64 Synthetic "
            f"clouds, one epoch):")
        out, _, _, sec = cli_run("cnn pretrain", ["--config", cfg, "--exp_name", "run",
                                                  "--root_folder", tmp], "pretrain_cnn_pcn",
                                 device, range(1))
        if out["state"].step != 8:
            fail(f"run cnn pretrain: {out['state'].step} optimizer steps, expected 8")
        log(f"  [{card}] Point_CAE_DGCNN pretrain through the CLI: {sec:.1f} s, best SVM acc "
            f"{out['best_acc']:.4f}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, (st, bz, pk, check) in records.items():
        extra = "" if check is None else \
            f"; card against CPU at batch {check[0]}: {check[1]:.2e} relative"
        log(f"  [{card}] cnn: {name} (bs {CNN_BATCH}): {st * 1e3:.2f} ms a step, busy "
            f"{bz / 1e3:.2f} ms, peak {pk / 2 ** 30:.2f} GiB{extra}")
    log(f"  [{card}] the cnn phase: {time.perf_counter() - t_phase:.1f} s")


HEADS_BATCH, HEADS_STEPS = BATCH, 5
_HEADS_ENC = {"patchify": 1, "gather_rows_small_c": 1, "mlp_ln_fwd": 12, "mlp_ln_bwd": 12,
              "attention_fwd": 12, "attention_bwd": 12}       # the masked encoder's 12 blocks
_HEADS_DEC = {**_HEADS_ENC, "mlp_ln_fwd": 16, "mlp_ln_bwd": 16, "attention_fwd": 16,
              "attention_bwd": 16}                           # and the decoder's 4
HEADS_RUNS = (   # (class, launches a step, checked on the card against the CPU)
    ("PointCAE_transformer", {**_HEADS_DEC, "nn_half_small": 1}, True),
    ("PointCAE_transformer_fc_global_fc_local", {**_HEADS_DEC, "nn_half_small": 1}, False),
    ("PointCAE_transformer_folding", {**_HEADS_DEC, "nn_half_small": 1}, True),
    ("PointCAE_transformer_folding_global_folding_local", {**_HEADS_DEC, "nn_half_small": 1},
     False),
    ("PointCAE_transformer_folding_global_fc_local", {**_HEADS_DEC, "nn_half_small": 1}, False),
    ("PointCAE_transformer_patch_center_only", _HEADS_ENC, False),
    ("PointCAE_transformer_fc_center", _HEADS_ENC, False),
    ("PointCAE_transformer_fold_center", _HEADS_ENC, False),
    ("PointCAE_transformer_fc_all", {**_HEADS_ENC, "nn_half_tiled": 1}, True),
    ("PointCAE_transformer_fold_all", {**_HEADS_ENC, "nn_half_tiled": 1}, False),
    # unmasked: 12 encoder blocks at T 64, R 16384; the two patch chamfers of the fine term
    ("PointCAE_transformer_v6_corase2fine_transformer", {**_HEADS_DEC, "nn_half_small": 2},
     False),
    ("PointCAE_transformer_v6_folding_corase2fine_transformer",
     {**_HEADS_DEC, "nn_half_small": 2}, True),
    ("PointCAE_transformer_supervised", _HEADS_ENC, True))
HEADS_TOL = 2e-2           # bf16 encoder (and decoder) products: 2% of the loss, as the flagship
RUN_SUP_CUT = {"max_epoch": 0, "total_bs": 32,               # one epoch of 64 clouds, 2 steps
               "model": {"NAME": "PointCAE_transformer_supervised"},
               "dataset": {"train": {"others": {"size": 64}}}}
RUN_OPT_CUT = {"max_epoch": 1,                               # 2 epochs of 8 batches
               "scheduler": {"type": "LambdaLR",
                             "kwargs": {"lr_decay": 0.5, "decay_step": 1, "lowest_decay": 0.02}},
               "step_per_update": 2,
               "bnmscheduler": {"kwargs": {"bn_momentum": 0.1, "bn_decay": 0.5,
                                           "decay_step": 1, "lowest_decay": 0.01}}}


def heads_config(name):
    """FLAGSHIP_CONFIG with model.NAME ``name``; the v6 heads unmasked
    (['affine_r3']): the reference refuses Drop-Patch for them."""
    config = copy.deepcopy(FLAGSHIP_CONFIG)
    config["model"]["NAME"] = name
    if "_v6_" in name:
        config["model"]["corrupt_type"] = ["affine_r3"]
    return config


def heads_kernels(torch, device, card):
    """The two chamfer kernels at the heads' new shapes against their plain
    halves, bit for bit, with their time a call: the patch chamfer over the
    v6 fine term's 16384 pairs of 32 and 32 points (twice a step) and the
    tiled chamfer at (256, 1024) x (256, 1024) (fc_all's and fold_all's
    whole-cloud loss)."""
    from point_dae_torch.losses import chamfer

    g = torch.Generator(device=device).manual_seed(SEED + 140)
    x = (0.2 * torch.randn((HEADS_BATCH * 64, 32, 3), generator=g, device=device)).contiguous()
    y = (0.2 * torch.randn((HEADS_BATCH * 64, 32, 3), generator=g, device=device)).contiguous()
    if not chamfer.use_small_kernel(x, 32):
        fail("heads: the patch chamfer's gate is closed at the v6 fine term's patches")
    kernel_vs_plain(torch, "heads: the patch chamfer (16384, 32, 32)",
                    chamfer.nn_half_small_pair(x, y),
                    chamfer.nn_half_small_plain(x, y) + chamfer.nn_half_small_plain(y, x))
    ms = cuda_ms(lambda: chamfer.nn_half_small_pair(x, y), 20)
    dev, _ = device_ms(lambda: chamfer.nn_half_small_pair(x, y), "the patch chamfer at 16384",
                       20)
    bound = bound_ms(2 * HEADS_BATCH * 64 * 32 * (12 + 12), 0, F32_FLOPS)
    log(f"  [{card}] patch chamfer 16384 pairs of 32 and 32 points, both directions, one "
        f"launch: {ms:.4f} ms a call, device {dev:.4f}, bit for bit with the plain halves; "
        f"bound {bound[0]:.4f} by {bound[1]}")
    a = torch.randn((HEADS_BATCH, 1024, 3), generator=g, device=device)
    b = torch.randn((HEADS_BATCH, 1024, 3), generator=g, device=device)
    if not chamfer.use_tiled_kernel(a, 1024):
        fail("heads: the tiled chamfer's gate is closed at (256, 1024)")
    kernel_vs_plain(torch, "heads: the tiled chamfer (256, 1024) x (256, 1024)",
                    chamfer.nn_half_tiled_pair(a, b),
                    chamfer.nn_half_tiled_plain(a, b) + chamfer.nn_half_tiled_plain(b, a))
    ms = cuda_ms(lambda: chamfer.nn_half_tiled_pair(a, b), 20)
    dev, _ = device_ms(lambda: chamfer.nn_half_tiled_pair(a, b), "the tiled chamfer at 256",
                       20)
    plain = cuda_ms(lambda: chamfer.nn_half_tiled_plain(a, b) + chamfer.nn_half_tiled_plain(b, a),
                    5)
    bound = bound_ms(2 * HEADS_BATCH * 1024 * (12 + 8), 2 * HEADS_BATCH * 1024 * 1024 * 9,
                     F32_FLOPS)
    log(f"  [{card}] tiled chamfer (256, 1024) x (256, 1024), both directions, one launch: "
        f"{ms:.4f} ms a call, device {dev:.4f}, bit for bit with the plain halves "
        f"({plain:.4f} ms); bound {bound[0]:.4f} by {bound[1]}")


def heads_check(torch, name, config, clean, labels, device, g):
    """The train-mode losses of ``name`` at CHECK_BATCH on the card
    (every kernel gate open) against the CPU (the plain paths) with the
    same weights, clouds and draws, within HEADS_TOL relative. Returns
    (the card's model, the larger relative gap)."""
    from point_dae_torch.engine.pretrain import init_model

    cpu_model = init_model(config, seed=SEED + 141, device="cpu")
    model = copy.deepcopy(cpu_model).to(device)
    draws = model.sample_draws(CHECK_BATCH, g, device)
    kw = {"labels": labels[:CHECK_BATCH]} if getattr(model, "is_supervised", False) else {}
    kc = {k: v.cpu() for k, v in kw.items()}
    cln = clean[:CHECK_BATCH]
    t0 = time.perf_counter()
    with torch.no_grad():
        lg = [float(v) for v in model(cln, cln, draws=draws, **kw)]
        lc = [float(v) for v in cpu_model(cln.cpu(), cln.cpu(), draws=on_device(draws, "cpu"),
                                          **kc)]
    err = max(abs(a - c) / max(abs(c), 1e-12) for a, c in zip(lg, lc) if a or c)
    log(f"  {name} at batch {CHECK_BATCH}: card losses {lg[0]:.7f} {lg[1]:.7f}; cpu "
        f"({time.perf_counter() - t0:.1f} s) {lc[0]:.7f} {lc[1]:.7f}; {err:.2e} relative")
    if not all(math.isfinite(v) for v in lg + lc) or err > HEADS_TOL:
        fail(f"heads: {name}: card losses {lg} off the CPU's {lc} beyond {HEADS_TOL} relative")
    return model, err


def heads_bnm_check(torch, device):
    """The bnmscheduler's re-blend on the card: one DGCNN step (bs 8) of two
    copies of a model with the same draws, one at momentum m: every running
    statistic's move is m / 0.1 times the other's."""
    from point_dae_torch.engine import pretrain
    from point_dae_torch.engine.train_state import TrainState

    config = load_cfg(RUN_DGCNN_CFG)
    raw = torch.randn((8, 2048, 6), generator=torch.Generator(device=device).manual_seed(
        SEED + 142), device=device)
    base = pretrain.init_model(config, seed=SEED + 143, device=device)
    moves = []
    for m in (None, 0.025):
        model = copy.deepcopy(base)
        state = TrainState.create(model, config, 8)
        step = pretrain.make_train_step(model, config, device=device)
        step(state, raw, generator=torch.Generator(device=device).manual_seed(SEED + 144),
             bn_momentum=m)
        moves.append([(bn.running_mean - b0.running_mean, bn.running_var - b0.running_var)
                      for bn, b0 in zip(pretrain.batch_norms(model), pretrain.batch_norms(base))])
    worst = max(float((s - 0.25 * p).abs().max() / p.abs().max().clamp_min(1e-12))
                for pairs_p, pairs_s in zip(*moves) for p, s in zip(pairs_p, pairs_s))
    if worst > 1e-4:
        fail(f"heads: the bnmscheduler's re-blend is off by {worst:.2e} of a move")
    return len(moves[0]), worst


def heads_cli(torch, device, card):
    """The two CLI runs on Synthetic clouds: the supervised pretrain from
    the cached flagship recipe (the streaming loader kept, labels from the
    set), and the DGCNN recipe under LambdaLR, step_per_update 2 and a
    bnmscheduler (half the batches update; the logged rates are the
    schedule's; the BatchNorm momentum moves with the epoch)."""
    import shutil
    import tempfile

    from point_dae_torch.engine import pretrain
    from point_dae_torch.engine.train_state import make_lr_schedule

    tmp = tempfile.mkdtemp(prefix="chip_smoke_heads_")
    try:
        cfg = write_config(RUN_FLAGSHIP_CFG, os.path.join(tmp, "cfgs", "pretrain_supervised.yaml"),
                           RUN_SUP_CUT)
        log(f"  {RUN_FLAGSHIP_CFG} with NAME PointCAE_transformer_supervised through the CLI "
            f"(64 Synthetic clouds, one epoch of 2 steps):")
        out, lines, _, sec = cli_run("supervised pretrain",
                                     ["--config", cfg, "--exp_name", "run", "--root_folder", tmp],
                                     "pretrain_supervised", device, range(1), validation=False)
        kept = lines.starting("[DeviceCache] supervised pretrain needs labels")
        if out["state"].step != 2 or len(kept) != 1:
            fail(f"run supervised pretrain: {out['state'].step} optimizer steps (expected 2), "
                 f"the streaming loader's line {kept}")
        log(f"    {kept[0]}")
        log(f"  [{card}] supervised pretrain through the CLI: {sec:.1f} s")

        cfg = write_config(RUN_DGCNN_CFG, os.path.join(tmp, "cfgs", "pretrain_optkeys.yaml"),
                           RUN_OPT_CUT)
        log(f"  {RUN_DGCNN_CFG} with {RUN_OPT_CUT} through the CLI:")
        seen, real = [], pretrain.make_train_step

        def watched(model, config, device=None):
            step = real(model, config, device=device)

            def call(*a, **k):
                seen.append(k.get("bn_momentum"))
                return step(*a, **k)
            return call

        pretrain.make_train_step = watched
        try:
            out, lines, exp, sec = cli_run("optimizer keys", ["--config", cfg, "--exp_name", "run",
                                                              "--root_folder", tmp],
                                           "pretrain_optkeys", device, range(2))
        finally:
            pretrain.make_train_step = real
        batches = 8 * 2
        want_m = [pretrain.bn_momentum_for(RUN_OPT_CUT["bnmscheduler"], e)
                  for e in range(2) for _ in range(8)]
        if out["state"].step != batches // 2:
            fail(f"run optimizer keys: {out['state'].step} optimizer steps for {batches} batches")
        if seen != want_m or len(set(seen)) != 2:
            fail(f"run optimizer keys: BatchNorm momenta {seen}, expected {want_m}")
        config = load_cfg(cfg)
        sched = make_lr_schedule(config, 8)
        tb = os.path.join(os.path.dirname(exp), "TFBoard", "run", "scalars.jsonl")
        rates = [json.loads(ln) for ln in open(tb) if '"Loss/Batch/LR"' in ln]
        if not rates or any(abs(r["value"] - sched(r["step"])) > 1e-12 * sched(r["step"])
                            for r in rates):
            fail(f"run optimizer keys: logged rates {rates} off the LambdaLR schedule")
        log(f"  [{card}] optimizer keys through the CLI: {sec:.1f} s, {out['state'].step} "
            f"updates for {batches} batches, BatchNorm momenta by epoch {sorted(set(seen))[::-1]}, "
            f"logged rates {[(r['step'], r['value']) for r in rates]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_transformer_heads(torch, device, card):
    """The 13 PointCAE transformer heads on FLAGSHIP_CONFIG's path (bs 256
    from (256, 8192, 6) raw clouds, trans_dim 384, depth 12 + 4, bf16;
    the v6 heads unmasked): the chamfer kernels at the heads' new shapes
    (heads_kernels); five heads (FC local, f32 folding, the whole-cloud
    tiled chamfer, coarse to fine, supervised) on the card against the CPU
    at CHECK_BATCH (heads_check); HEADS_STEPS steps of each head with its
    launches a step held to HEADS_RUNS (no folding kernel launch), the
    median step time, a profiled step's busy time and the peak memory; the
    bnmscheduler's re-blend on the card (heads_bnm_check); the two CLI runs
    (heads_cli)."""
    from point_dae_torch.engine.pretrain import device_pipeline

    t_phase = time.perf_counter()
    heads_kernels(torch, device, card)
    torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(SEED + 145)
    raw = torch.randn((HEADS_BATCH, NRAW, 6), generator=g, device=device)
    d = FLAGSHIP_CONFIG["dataset"]["train"]["others"]
    _, clean = device_pipeline(raw, d["aug_type"], d["corrupt_type"], d["npoints"],
                               generator=g, device=device)
    labels = torch.randint(0, 55, (HEADS_BATCH,), generator=g, device=device)
    records = {}
    for name, want, checked in HEADS_RUNS:
        config = heads_config(name)
        model, err = heads_check(torch, name, config, clean, labels, device, g) if checked \
            else (None, None)
        steady, first, launches, peak, one_more = run_steps(
            torch, config, raw, device, HEADS_STEPS, SEED + 146, model=model,
            labels=labels if "supervised" in name else None)
        per_step = {k: v / HEADS_STEPS for k, v in launches.items() if v}
        if per_step != want:
            fail(f"heads: {name}: launches a step {per_step}, expected {want}")
        busy, _ = profile_step(torch, one_more, card, top=4)
        records[name] = (steady, busy, peak, err)
        log(f"  [{card}] {name}: step {steady * 1e3:.2f} ms (median of steps 2-{HEADS_STEPS}), "
            f"first {first * 1e3:.1f} ms, busy {busy / 1e3:.2f} ms, max_memory_allocated "
            f"{peak / 2 ** 30:.2f} GiB; launches a step {per_step}")
        del model, one_more
        torch.cuda.empty_cache()
    del raw, clean
    torch.cuda.empty_cache()
    n_bn, worst = heads_bnm_check(torch, device)
    log(f"  [{card}] bnmscheduler on the card: {n_bn} BatchNorms, each move at momentum 0.025 "
        f"0.25 times the fixed one's within {worst:.2e}")
    heads_cli(torch, device, card)
    for name, (st, bz, pk, err) in records.items():
        extra = "" if err is None else f"; card against CPU at batch {CHECK_BATCH}: {err:.2e}"
        log(f"  [{card}] heads: {name} (bs {HEADS_BATCH}): {st * 1e3:.2f} ms a step, busy "
            f"{bz / 1e3:.2f} ms, peak {pk / 2 ** 30:.2f} GiB{extra}")
    log(f"  [{card}] the transformer heads phase: {time.perf_counter() - t_phase:.1f} s")


PAR_STEPS = 5              # (a): flagship steps without and with a group of one
PAR_PAIR_STEPS = 2         # (b), (c): the tiered contract's two steps
PAR_FLAGSHIP_KERNELS = ("patchify", "gather_rows_small_c", "mlp_ln_fwd", "folding_fwd",
                        "attention_fwd", "nn_half_small")
PAR_CHILD = "PARALLEL_CHILD "
# (tag, model, global batch, products' dtype, (step-1, step-2) relative
# bounds): tests/test_multihost.py's contract, in f32, for the flagship; the
# bf16 flagship (the kernels' path) is bounded at step 1 by 1e-4: its half
# batches' bf16 products round apart from a whole batch's (3.3e-05 on the
# card, where the same step in f32 differs by 1.4e-07); the full-width
# DGCNN's step 1 by 1e-4 too: its BatchNorm sums over 2.6 M edge rows a
# layer, and the neighbour choices downstream of them, move with the order
# of reduction (two ranks 2.9e-05 from one process on the card, and one
# process 2.6e-05 from itself with its batch's rows reversed;
# ``--parallel-readings`` reads these and the faults below)
PAR_PAIRS = (("b", "flagship", BATCH, "f32", (2e-5, 5e-3)),
             ("b", "flagship", BATCH, "bf16", (1e-4, 5e-3)),
             ("c", "dgcnn", DGCNN_BATCH, "f32", (1e-4, 5e-3)))
# beside the losses, in every set: each BatchNorm's running mean and
# variance after step 1, two ranks against one process (the largest
# difference over the largest value), within PAR_BN_TOL; and the two ranks'
# parameters and buffers after the last step, bit for bit. A rank that
# kept its statistics to its own rows moves the first, a dropped gradient
# all-reduce the second (PAR_FAULTS, read by ``--parallel-readings``). On
# the card the statistics read 4.3e-07, 1.8e-07 and 3.2e-06 (f32 flagship,
# bf16 flagship, DGCNN), and 1.0e-03, 1.0e-03 and 7.1e-03 with each rank's
# statistics its own rows'
PAR_BN_TOL = 1e-4
PAR_FAULTS = ("local_stats", "no_allreduce")
EMD_SHAPE = (32, 1024, 3)


def _par_run(torch, config, raw_of, steps, device, seed):
    """``steps`` train steps of a model from ``seed`` (``raw_of(i)``: this
    rank's i-th raw batch and its global batch's hash): (the record, the
    model). The record holds the losses, the host ms a step, the global
    batches' hashes, the launches, every BatchNorm's running mean and
    variance after step 1, and a hash of the parameters and buffers after
    the last step."""
    import hashlib

    from point_dae_torch.engine.pretrain import batch_norms, init_model, make_train_step
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.utils import kernels

    model = init_model(config, seed=seed, device=device)
    state = TrainState.create(model, config, steps_per_epoch=100)
    step = make_train_step(model, config, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    run = {"losses": [], "ms": [], "hashes": []}
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i in range(steps):
        raw, digest = raw_of(i)
        run["hashes"].append(digest)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, raw, generator=gen)
        torch.cuda.synchronize()
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        run["losses"].append([float(m["loss_xyz"]), float(m["loss_normal"])])
        if i == 0:
            run["bn_stats"] = torch.cat([t.float().reshape(-1) for bn in batch_norms(model)
                                         for t in (bn.running_mean, bn.running_var)]).tolist()
    run["launches"] = {k: v for k, v in kernels.launches.items() if v}
    sha = hashlib.sha1()
    for t in list(model.parameters()) + list(model.buffers()):
        sha.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    run["state_sha1"] = sha.hexdigest()
    return run, model


def _reversed_rows(torch, x, plan, rev):
    """A step's draws with the batch's rows in the order ``rev``, along each
    tensor's batch axis (``plan``, from ``parallel/mesh.py:_batch_dims``)."""
    if isinstance(x, torch.Tensor):
        return x if plan is None else x.index_select(plan, rev.to(x.device))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _reversed_rows(torch, getattr(x, f.name),
                                                                plan[f.name], rev)
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, (list, tuple)):
        return type(x)(_reversed_rows(torch, v, p, rev) for v, p in zip(x, plan))
    return x


def reorder_noise(torch, config, raw, device, seed) -> float:
    """The relative change of one process's step-1 loss_xyz (a train-mode
    forward) when the batch's rows and their draws come in reverse order:
    what reduction order alone moves the loss by at this width (BatchNorm
    sums, and the neighbour choices downstream of them)."""
    from point_dae_torch.engine.pretrain import device_pipeline, init_model, sample_step_draws
    from point_dae_torch.parallel.mesh import _batch_dims

    d = config["dataset"]["train"]["others"]
    aug, cor = tuple(d.get("aug_type", ("norm",))), tuple(d.get("corrupt_type", ("clean",)))
    npoints = int(d.get("npoints", 1024))
    model = init_model(config, seed=seed, device=device)
    model.train()
    B, n = raw.shape[:2]

    def sample(b, seed_):
        return sample_step_draws(model, aug, cor, npoints, b, n,
                                 torch.Generator(device=device).manual_seed(seed_), device)

    plan = _batch_dims(sample(B, 0), sample(B + 1, 0))
    draws = sample(B, seed + 1)
    rev = torch.arange(B - 1, -1, -1, device=device)
    losses = []
    with torch.no_grad():
        for r, dr in ((raw, draws), (raw[rev], _reversed_rows(torch, draws, plan, rev))):
            corrupted, clean = device_pipeline(r, aug, cor, npoints, draws=dr.pipeline,
                                               device=device)
            losses.append(float(model(corrupted, clean, draws=dr.model)[0]))
    del model
    torch.cuda.empty_cache()
    return abs(losses[1] - losses[0]) / abs(losses[0])


def _break_group(fault) -> None:
    """Break the group on purpose (``--parallel-readings``):
    ``local_stats`` keeps BatchNorm's statistics to each rank's rows,
    ``no_allreduce`` drops the gradient all-reduce."""
    if fault == "local_stats":
        from point_dae_torch.models import dgcnn, layers
        from point_dae_torch.parallel import Mesh

        layers.get_mesh = dgcnn.get_mesh = Mesh
    elif fault == "no_allreduce":
        from point_dae_torch.engine import train_state

        train_state.all_reduce_gradients = lambda params, mesh: None
    elif fault is not None:
        raise ValueError(f"fault {fault!r}")


def parallel_child(spec: dict) -> dict:
    """One rank of the parallel phase (``python3 chip_smoke.py
    --parallel-child '<spec>'``)."""
    import hashlib

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from point_dae_torch.data.datasets import build_dataset_from_cfg
    from point_dae_torch.data.loader import DataLoader
    from point_dae_torch.parallel import (all_gather_rows, all_reduce_gradients, destroy,
                                          get_mesh, initialize_distributed, train_loader)
    from point_dae_torch.utils.config import ConfigDict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = {"mode": spec["mode"], "rank": spec["rank"], "world": spec["world"]}
    if spec["mode"] == "group_of_one":
        config = ConfigDict(copy.deepcopy(FLAGSHIP_CONFIG))
        torch.use_deterministic_algorithms(True, warn_only=True)
        g = torch.Generator(device=device).manual_seed(SEED + 150)
        raw = torch.randn((BATCH, NRAW, 6), generator=g, device=device)
        runs = {}
        for name in ("no group", "group"):
            if name == "group":
                initialize_distributed(coordinator_address=spec["init"], num_processes=1,
                                       process_id=0, device="cuda:0", timeout_s=60)
            mesh = get_mesh()
            run, model = _par_run(torch, config, lambda i: (raw, None), PAR_STEPS, device,
                                  SEED + 151)
            runs[name] = dict(run, world=mesh.world, group=mesh.group is not None)
            if name == "group":       # the gradient all-reduce alone, on the last step's
                params = [p for p in model.parameters() if p.requires_grad]
                all_reduce_gradients(params, mesh)
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(True), torch.cuda.Event(True)
                t0 = time.perf_counter()
                start.record()
                for _ in range(20):
                    all_reduce_gradients(params, mesh)
                end.record()
                t_host = time.perf_counter() - t0
                torch.cuda.synchronize()
                out["allreduce_ms"] = start.elapsed_time(end) / 20
                out["allreduce_host_ms"] = t_host * 1e3 / 20
                out["allreduce_bytes"] = sum(p.numel() * p.element_size() for p in params)
                out["allreduce_params"] = len(params)
                del params
            del model
            torch.cuda.empty_cache()
        out["runs"] = runs
        destroy()
        return out
    if spec.get("tp"):
        return dict(out, **tp_child(torch, spec, device))
    # a pair of gloo ranks on the one card, or the one process it is held
    # to: every set of PAR_PAIRS in turn, in one group
    world, rank = spec["world"], spec["rank"]
    _break_group(spec.get("fault"))
    if world > 1:
        initialize_distributed(init_method=spec["init"], num_processes=world,
                               process_id=rank, device="cuda:0", backend="gloo",
                               timeout_s=60)
    mesh = get_mesh()
    out["sets"] = []
    for _, model_name, batch, dtype, _ in PAR_PAIRS:
        config = ConfigDict(copy.deepcopy(FLAGSHIP_CONFIG if model_name == "flagship"
                                          else DGCNN_CONFIG))
        config["total_bs"] = batch
        if model_name == "flagship":
            config["model"]["transformer_config"]["dtype"] = dtype
        else:
            config["model"]["dtype"] = dtype
        ds = build_dataset_from_cfg({"NAME": "Synthetic", "N_POINTS": NRAW, "num_classes": 8,
                                     "with_normal": True},
                                    {"subset": "train", "size": batch * PAR_PAIR_STEPS},
                                    device="cpu")
        batches = iter(train_loader(ds, batch, SEED, mesh))
        noise = None
        if spec.get("noise"):
            first = next(iter(DataLoader(ds, batch, shuffle=True, seed=SEED)))["points"]
            noise = reorder_noise(torch, config, torch.from_numpy(first).to(device), device,
                                  SEED + 160)

        def raw_of(i):
            raw = torch.from_numpy(next(batches)["points"]).to(device)
            full = all_gather_rows(mesh, raw)
            return raw, hashlib.sha1(full.cpu().numpy().tobytes()).hexdigest()

        run, model = _par_run(torch, config, raw_of, PAR_PAIR_STEPS, device, SEED + 160)
        out["sets"].append(dict(run, noise=noise))
        del model, batches
        torch.cuda.empty_cache()
    destroy()
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_children(specs, timeout: float = 300.0) -> list:
    """Start one child a spec, all together; wait for them; return each
    child's JSON line, failing the run if a child fails or prints none."""
    # cuBLAS's fixed workspace: the same products round alike in every run
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-child",
                               json.dumps(sp)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for sp in specs]
    outs = []
    try:
        for sp, proc in zip(specs, procs):
            text, _ = proc.communicate(timeout=timeout)
            lines = [ln for ln in text.splitlines() if ln.startswith(PAR_CHILD)]
            if proc.returncode != 0 or not lines:
                fail(f"parallel: child {sp} exited {proc.returncode}:\n{text[-3000:]}")
            outs.append(json.loads(lines[-1][len(PAR_CHILD):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def run_pair(fault=None) -> list:
    """Two gloo ranks on the card, each running every set of PAR_PAIRS:
    each rank's records, set by set."""
    tmp = tempfile.mkdtemp(prefix="pdae_par_")
    try:
        duo = run_children([{"mode": "pair", "rank": r, "world": 2, "fault": fault,
                             "init": f"file://{os.path.join(tmp, 'store')}"}
                            for r in range(2)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [d["sets"] for d in duo]


def pair_readings(single, r0, r1) -> dict:
    """Two ranks' records of one set against one process's: each step's
    relative loss differences, the BatchNorm statistics' difference after
    step 1 over their largest value, and whether the batches' hashes and
    the two ranks' losses and final states agree."""
    import numpy as np

    rel = [[abs(x - y) / abs(y) if y else abs(x) for x, y in zip(d, s)]
           for s, d in zip(single["losses"], r0["losses"])]
    a, b = np.asarray(r0["bn_stats"]), np.asarray(single["bn_stats"])
    return {"rel": rel, "bn": float(np.abs(a - b).max() / np.abs(b).max()),
            "hashes": single["hashes"] == r0["hashes"] == r1["hashes"],
            "ranks_losses": r0["losses"] == r1["losses"],
            "ranks_state": r0["state_sha1"] == r1["state_sha1"]}


def _fmt_rel(rel) -> list:
    return [[f"{v:.1e}" for v in step] for step in rel]


def emd_check(torch, device, card) -> None:
    """(d): emd_loss and its gradients on the card against the CPU, the
    loss within 1e-5 and each gradient within 1e-3 of its largest value:
    the match is ten rounds of exp(-4^j d), j down from 7, so a distance's
    last bit moves it; beside them, the CPU against itself with xyz2's
    points in reverse order (the same sums in another order)."""
    from point_dae_torch.losses import emd_loss

    g = torch.Generator().manual_seed(SEED + 170)
    a = torch.rand(EMD_SHAPE, generator=g) * 2 - 1
    b = torch.rand(EMD_SHAPE, generator=g) * 2 - 1
    rev = torch.arange(EMD_SHAPE[1] - 1, -1, -1)
    res = {}
    for name, dev, bb in (("cpu", "cpu", b), ("card", device, b), ("cpu reversed", "cpu", b[:, rev])):
        ta = a.to(dev).clone().requires_grad_(True)
        tb = bb.to(dev).clone().requires_grad_(True)
        loss = emd_loss(ta, tb)
        loss.backward()
        gb = tb.grad[:, rev] if name == "cpu reversed" else tb.grad
        res[name] = [t.detach().cpu() for t in (loss, ta.grad, gb)]

    def errs(name):
        return [float(((x - y).abs().max() / y.abs().max()))
                for x, y in zip(res[name], res["cpu"])]

    card_err, cpu_err = errs("card"), errs("cpu reversed")
    ga, gb = a.to(device), b.to(device)
    ms = cuda_ms(lambda: emd_loss(ga, gb), 5)
    log(f"  [{card}] (d) emd_loss {EMD_SHAPE} x {EMD_SHAPE}: {float(res['cpu'][0]):.6f} on "
        f"the CPU; card against CPU, relative to the largest: loss {card_err[0]:.2e}, grad "
        f"xyz1 {card_err[1]:.2e}, grad xyz2 {card_err[2]:.2e} (the CPU against itself with "
        f"xyz2 reversed: {cpu_err[0]:.2e}, {cpu_err[1]:.2e}, {cpu_err[2]:.2e}); {ms:.3f} ms "
        f"a forward on the card")
    if card_err[0] > 1e-5 or max(card_err[1:]) > 1e-3:
        fail(f"parallel: emd_loss on the card disagrees with the CPU: {card_err}")


def phase_parallel(torch, device, card) -> None:
    """Data parallelism, each rank a child process (see the module's
    docstring, phase 28)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # (a) a group of one over nccl against no group, in one child
    a = run_children([{"mode": "group_of_one", "rank": 0, "world": 1,
                       "init": f"127.0.0.1:{_free_port()}"}])[0]
    plain, grouped = a["runs"]["no group"], a["runs"]["group"]
    if not grouped["group"] or plain["group"]:
        fail(f"parallel (a): the group did not form as asked: {a['runs']}")
    log(f"  [{card}] (a) flagship bs {BATCH}, {PAR_STEPS} steps, deterministic mode: losses "
        f"no group {plain['losses']}, nccl group of one {grouped['losses']}")
    log(f"  [{card}] (a) step ms no group {[round(t, 2) for t in plain['ms']]}, group "
        f"{[round(t, 2) for t in grouped['ms']]}; the gradient all-reduce alone "
        f"{a['allreduce_ms']:.3f} ms a step on the card, {a['allreduce_host_ms']:.3f} ms on "
        f"the host ({a['allreduce_params']} gradients, "
        f"{a['allreduce_bytes'] / 2 ** 20:.1f} MiB)")
    launched = {k: grouped["launches"].get(k, 0) for k in PAR_FLAGSHIP_KERNELS}
    log(f"  [{card}] (a) launches in the group's {PAR_STEPS} steps: {launched}")
    if plain["losses"] != grouped["losses"]:
        fail(f"parallel (a): the group of one changed the losses: {plain['losses']} against "
             f"{grouped['losses']}")
    if min(launched.values()) == 0:
        fail(f"parallel (a): a flagship kernel did not launch under the group: {launched}")
    # (b), (c): two gloo ranks on the card against one process, each child
    # running every set of PAR_PAIRS
    singles = run_children([{"mode": "pair", "rank": 0, "world": 1}])[0]["sets"]
    r0s, r1s = run_pair()
    for (tag, model, batch, dtype, (tol1, tol2)), single, r0, r1 in zip(
            PAR_PAIRS, singles, r0s, r1s):
        what = f"({tag}) {model} {dtype}"
        rd = pair_readings(single, r0, r1)
        log(f"  [{card}] {what}: 2 gloo ranks x {batch // 2} against 1 x {batch}: losses "
            f"{r0['losses']} / {single['losses']} (relative {_fmt_rel(rd['rel'])}); "
            f"BatchNorm statistics after step 1 {rd['bn']:.1e} of their largest; step ms "
            f"rank 0 {[round(t, 1) for t in r0['ms']]}, rank 1 "
            f"{[round(t, 1) for t in r1['ms']]}, one process "
            f"{[round(t, 1) for t in single['ms']]}; launches rank 0 {r0['launches']}")
        if not rd["hashes"]:
            fail(f"parallel {what}: the global batches differ from one process's")
        if not (rd["ranks_losses"] and rd["ranks_state"]):
            fail(f"parallel {what}: the ranks report different losses or hold different "
                 f"parameters")
        if rd["bn"] > PAR_BN_TOL:
            fail(f"parallel {what}: BatchNorm's running statistics after step 1 are "
                 f"{rd['bn']:.1e} from one process's (bound {PAR_BN_TOL})")
        if max(rd["rel"][0]) > tol1 or max(max(v) for v in rd["rel"][1:]) > tol2:
            fail(f"parallel {what}: outside the contract (step 1 {tol1}, step 2 {tol2}): "
                 f"{rd['rel']}")
    emd_check(torch, device, card)
    log(f"  [{card}] the parallel phase: {time.perf_counter() - t_phase:.1f} s")


def parallel_readings(card) -> None:
    """``python3 chip_smoke.py --parallel-readings``: what the checks of
    (b) and (c) read with nothing wrong, beside one process's own step-1
    change when its batch's rows are reversed (reorder_noise), and under
    each of PAR_FAULTS; it prints them and fails only if a child does."""
    t0 = time.perf_counter()
    singles = run_children([{"mode": "pair", "rank": 0, "world": 1, "noise": True}])[0]["sets"]
    for (tag, model, batch, dtype, tols), single in zip(PAR_PAIRS, singles):
        log(f"  [{card}] ({tag}) {model} {dtype}: one process's own step-1 loss_xyz under "
            f"the batch's rows reversed: relative {single['noise']:.1e}")
    for fault in (None,) + PAR_FAULTS:
        r0s, r1s = run_pair(fault)
        for (tag, model, batch, dtype, (tol1, tol2)), single, r0, r1 in zip(
                PAR_PAIRS, singles, r0s, r1s):
            rd = pair_readings(single, r0, r1)
            caught = [name for name, bad in (
                ("step 1", max(rd["rel"][0]) > tol1),
                ("step 2", max(max(v) for v in rd["rel"][1:]) > tol2),
                ("BatchNorm statistics", rd["bn"] > PAR_BN_TOL),
                ("ranks' states", not rd["ranks_state"]),
                ("ranks' losses", not rd["ranks_losses"])) if bad]
            log(f"  [{card}] ({tag}) {model} {dtype}, fault {fault}: relative losses "
                f"{_fmt_rel(rd['rel'])}, BatchNorm statistics {rd['bn']:.1e}, batches "
                f"{'equal' if rd['hashes'] else 'DIFFERENT'}, ranks' states "
                f"{'equal' if rd['ranks_state'] else 'different'}; failed checks: "
                f"{caught or 'none'}")
    log(f"  [{card}] the readings: {time.perf_counter() - t0:.1f} s")


TP_STEPS = 3
# the bf16 flagship's losses against one process, fixed (PERF.md, section
# 6, tensor parallelism). Step 1 cannot reach 1e-4 in bf16: cuBLAS picks
# a product's kernel, and the order of its f32 sums, by the product's shape,
# and a rank's qkv (N 576) and split proj round apart from the whole ones
# (1.93e-4 measured; one process with its products at a rank's shapes lands
# on the ranks' step-1 losses bit for bit). Step 2: 2.4e-4 measured; a first
# design that rounded each rank's part of a gradient before the model
# group's sum read 4.0e-3 (step 1 cannot tell the two apart: they differ in
# the backward). Step 3 printed.
TP_BF16_TOLS = (2.5e-4, 1e-3)
TP_F32_STEPS = 2
# the same pair in f32 (the plain routes, TF32 off), where only the sums'
# order moves: 0.0 / 8.7e-8 at step 1 and 1.6e-5 at step 2 in a diagnostic run
TP_F32_TOLS = (1e-6, 1e-4)
TP_LR = 1e-3               # FLAGSHIP_CONFIG's rate: AdamW's first step moves an element <= lr
TP_PARAM_ATOL = 1e-5       # 1% of one AdamW step
# of the whole parameters' elements after step 1 within TP_PARAM_ATOL of one
# process's, but the BatchNorm-fed biases: AdamW's first step moves each by
# lr g / (|g| + 1e-8), so an element whose gradient is near zero or near eps
# moves apart on rounding alone (99.49% measured in bf16, 99.981% in f32)
TP_PARAM_SHARE = 0.99
# f32: AdamW's first moment after step 1 (0.1 times the clipped gradient),
# gathered whole, against one process's, each tensor's largest difference
# over its largest value, the BatchNorm-fed biases apart: the backward's
# collectives held where the parameters' sign-like first step cannot be.
# 2.37e-4 measured (the first conv's BatchNorm weight, whose gradient is a
# sum over 524288 points), 1.33 with copy_to_model dropped (PERF.md, section 6)
TP_F32_GRAD_TOL = 1e-3
# biases followed by a BatchNorm: their true gradient is zero, its rounding
# noise takes AdamW's first step either way (tests/test_torch_flagship.py)
TP_NULL_GRAD = ("MAE_encoder.encoder.first_conv.0.bias", "MAE_encoder.encoder.first_conv.3.bias",
                "MAE_encoder.encoder.second_conv.0.bias")


def tp_child(torch, spec, device) -> dict:
    """One rank of the tensor_parallel phase (``tp``: the model axis's
    ranks; 1 for the one process it is held to): FLAGSHIP_CONFIG at full
    width from one seed, the ViT blocks split over the model group
    (``parallel/mesh.py:shard_params``). In bf16, TP_STEPS steps with the
    launch counters zeroed before and read after, the heads of each
    attention kernel call and the weights each ``mlp_ln`` call takes, then
    one more step with the model group's all-reduces counted (calls, bytes,
    host ms with the card synchronized around each); in f32, TP_F32_STEPS
    steps; on the ranks, the planted faults the checks must catch: one
    bf16 step with ``reduce_from_model`` dropped, one f32 step with
    ``copy_to_model`` dropped. The whole parameters and AdamW's first
    moments after step 1 of a run (``gather_params``,
    ``gather_optimizer_state``) go to ``spec['dump']`` + ``_<run>.pt``,
    written by model rank 0."""
    import hashlib

    import torch.distributed as dist

    from point_dae_torch.engine.pretrain import init_model, make_train_step
    from point_dae_torch.engine.train_state import TrainState
    from point_dae_torch.models import layers
    from point_dae_torch.parallel import (destroy, gather_params, get_mesh, get_mesh_2d,
                                          initialize_distributed, shard_params)
    from point_dae_torch.parallel.mesh import gather_optimizer_state
    from point_dae_torch.utils import kernels
    from point_dae_torch.utils.config import ConfigDict

    world, rank = spec["world"], spec["rank"]
    if world > 1:
        initialize_distributed(init_method=spec["init"], num_processes=world, process_id=rank,
                               device="cuda:0", backend="gloo", timeout_s=120)
        get_mesh_2d(model_parallel=spec["tp"])
    mesh = get_mesh()
    g = torch.Generator(device=device).manual_seed(SEED + 180)
    raw = torch.randn((BATCH, NRAW, 6), generator=g, device=device)
    seen = {"heads": set(), "mlp_ln_w1": set()}
    attention, mlp_ln = layers.fused_attention, layers.fused_mlp_ln

    def attention_seen(q, k, v, key_mask=None):
        seen["heads"].add(int(q.shape[2]))
        return attention(q, k, v, key_mask)

    def mlp_ln_seen(x, gamma, beta, w1, *rest, **kw):
        seen["mlp_ln_w1"].add(tuple(w1.shape))
        return mlp_ln(x, gamma, beta, w1, *rest, **kw)

    coll = {"calls": 0, "bytes": 0, "ms": 0.0}
    all_reduce = dist.all_reduce

    def counted(t, *a, group=None, **kw):
        if mesh.model_group is None or group is not mesh.model_group:
            return all_reduce(t, *a, group=group, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        work = all_reduce(t, *a, group=group, **kw)
        torch.cuda.synchronize()
        coll["ms"] += (time.perf_counter() - t0) * 1e3
        coll["calls"] += 1
        coll["bytes"] += t.numel() * t.element_size()
        return work

    def train(dtype, steps, dump=None, count=False):
        config = ConfigDict(copy.deepcopy(FLAGSHIP_CONFIG))
        config["model"]["transformer_config"]["dtype"] = dtype
        model = shard_params(mesh, init_model(config, seed=SEED + 181, device=device))
        state = TrainState.create(model, config, steps_per_epoch=100)
        step = make_train_step(model, config, device=device)
        gen = torch.Generator(device=device).manual_seed(SEED + 182)
        rec = {"losses": [], "ms": []}
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, raw, generator=gen)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append([float(m["loss_xyz"]), float(m["loss_normal"])])
            if i == 0:
                rec["launches"] = {k: v for k, v in kernels.launches.items() if v}
                if dump:       # collectives over the model group: every rank gathers
                    whole = gather_params(mesh, model)
                    moments = gather_optimizer_state(mesh, model, state.optimizer)["state"]
                    if mesh.model_rank == 0:
                        ps = [p for g in state.optimizer.param_groups for p in g["params"]]
                        names = {id(p): n for n, p in model.named_parameters()}
                        torch.save({"params": {k: v.cpu() for k, v in whole.items()},
                                    "exp_avg": {names[id(ps[int(i)])]: e["exp_avg"].cpu()
                                                for i, e in moments.items()}},
                                   f"{spec['dump']}_{dump}.pt")
                    del whole, moments
        rec["launches_all"] = {k: v for k, v in kernels.launches.items() if v}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if count:      # one more step, its model-group all-reduces counted
            coll.update(calls=0, bytes=0, ms=0.0)
            dist.all_reduce = counted
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, raw, generator=gen)
            torch.cuda.synchronize()
            dist.all_reduce = all_reduce
            rec["coll"] = dict(coll, step_ms=(time.perf_counter() - t0) * 1e3)
        shards = {n for n, p in model.named_parameters()
                  if getattr(p, "tp_dim", None) is not None}
        rec["shards"] = len(shards)
        for what, keep in (("replicated", lambda n: n not in shards),
                           ("shards", shards.__contains__)):
            sha = hashlib.sha1()
            for n, t in model.state_dict().items():
                if keep(n):
                    sha.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu()
                               .numpy().tobytes())
            rec[f"sha_{what}"] = sha.hexdigest()
        del model, state, step
        torch.cuda.empty_cache()
        return rec

    layers.fused_attention, layers.fused_mlp_ln = attention_seen, mlp_ln_seen
    out = {"bf16": train("bf16", TP_STEPS, dump="bf16", count=world > 1)}
    layers.fused_attention, layers.fused_mlp_ln = attention, mlp_ln
    out["heads"], out["mlp_ln_w1"] = sorted(seen["heads"]), sorted(seen["mlp_ln_w1"])
    out["f32"] = train("f32", TP_F32_STEPS, dump="f32")
    if world > 1:      # planted faults: the forward's sum, the backward's sum dropped
        reduce_from_model, copy_to_model = layers.reduce_from_model, layers.copy_to_model
        layers.reduce_from_model = lambda x, mesh_: x
        out["no_reduce"] = train("bf16", 1)
        layers.reduce_from_model = reduce_from_model
        layers.copy_to_model = lambda x, mesh_: x
        out["no_copy"] = train("f32", 1, dump="no_copy")
        layers.copy_to_model = copy_to_model
    out["model_rank"], out["global_rank"] = mesh.model_rank, mesh.global_rank
    destroy()
    return out


def tp_param_readings(one: dict, tp: dict) -> dict:
    """The whole parameters after step 1 of the model axis's run against
    one process's: the largest difference, the share of the elements
    within TP_PARAM_ATOL (the BatchNorm-fed biases apart) and the largest
    difference of those biases; and AdamW's first moments: the largest
    difference over the tensor's largest value, and its tensor."""
    worst, within, total, null = 0.0, 0, 0, 0.0
    worst_name = None
    params = one["params"]
    for k, v in params.items():
        if not v.dtype.is_floating_point or "running_" in k or "num_batches" in k:
            continue
        d = (tp["params"][k].float() - v.float()).abs()
        if k in TP_NULL_GRAD:
            null = max(null, float(d.max()))
            continue
        if float(d.max()) > worst:
            worst, worst_name = float(d.max()), k
        within += int((d <= TP_PARAM_ATOL).sum())
        total += d.numel()
    grad = {k: float((tp["exp_avg"][k] - v).abs().max() / v.abs().max().clamp_min(1e-30))
            for k, v in one["exp_avg"].items() if k not in TP_NULL_GRAD}
    grad_name = max(grad, key=grad.get)
    return {"worst": worst, "worst_name": worst_name, "share": within / total, "null": null,
            "grad": grad[grad_name], "grad_name": grad_name,
            "same_keys": params.keys() == tp["params"].keys()
            and all(params[k].shape == tp["params"][k].shape for k in params)
            and one["exp_avg"].keys() == tp["exp_avg"].keys()}


def tp_loss_misses(rel, tols) -> list:
    """The steps (1-based) whose relative loss differences exceed their
    bound in ``tols`` (steps past ``tols`` are printed, not held)."""
    return [i + 1 for i, (r, tol) in enumerate(zip(rel, tols)) if max(r) > tol]


def phase_tensor_parallel(torch, device, card, g) -> tuple:
    """Tensor parallelism (see the module's docstring, phase 29): the
    attention kernels at the model axis's H 3 against their plain version,
    then FLAGSHIP_CONFIG on two gloo ranks at tp 2 against one process, in
    bf16 and in f32, and one planted fault. Returns (the kernels' records
    at H 3, rank 0's launches over its bf16 steps)."""
    t_phase = time.perf_counter()
    records = phase_attention(torch, device, g, heads=3)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="pdae_tp_")
    try:
        one, = run_children([{"mode": "pair", "tp": 1, "rank": 0, "world": 1,
                              "dump": os.path.join(tmp, "one")}])
        duo = run_children([{"mode": "pair", "tp": 2, "rank": r, "world": 2,
                             "dump": os.path.join(tmp, "tp"),
                             "init": f"file://{os.path.join(tmp, 'store')}"} for r in range(2)])
        rd = {run: tp_param_readings(
            torch.load(os.path.join(tmp, f"one_{run.replace('no_copy', 'f32')}.pt"),
                       weights_only=True),
            torch.load(os.path.join(tmp, f"tp_{run}.pt"), weights_only=True))
            for run in ("bf16", "f32", "no_copy")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def relative(a, b):
        return [[abs(x - y) / abs(y) for x, y in zip(p, q)] for p, q in zip(a, b)]

    r0, r1 = duo
    bf, c = r0["bf16"], r0["bf16"]["coll"]
    tols = {"bf16": TP_BF16_TOLS, "f32": TP_F32_TOLS}
    rel = {dt: relative(r0[dt]["losses"], one[dt]["losses"]) for dt in tols}
    fault = relative(r0["no_reduce"]["losses"], one["bf16"]["losses"][:1])
    for dt in tols:
        log(f"  [{card}] tensor_parallel: FLAGSHIP_CONFIG bs {BATCH}, {dt}, 2 gloo ranks at "
            f"tp 2 (dp 1) against one process: losses {r0[dt]['losses']} / "
            f"{one[dt]['losses']} (relative {_fmt_rel(rel[dt])}; bounds {tols[dt]}); "
            f"{r0[dt]['shards']} split tensors a rank; step ms rank 0 "
            f"{[round(t, 1) for t in r0[dt]['ms']]}, rank 1 "
            f"{[round(t, 1) for t in r1[dt]['ms']]}, one process "
            f"{[round(t, 1) for t in one[dt]['ms']]}; peak {r0[dt]['peak_gib']:.2f} / "
            f"{one[dt]['peak_gib']:.2f} GiB")
        log(f"  [{card}] tensor_parallel: {dt} whole parameters after step 1 against one "
            f"process: largest difference {rd[dt]['worst']:.2e} ({rd[dt]['worst_name']}), "
            f"{100 * rd[dt]['share']:.4f}% within {TP_PARAM_ATOL}, the BatchNorm-fed biases "
            f"{rd[dt]['null']:.2e}; AdamW's first moments: largest difference "
            f"{rd[dt]['grad']:.2e} of the tensor's largest ({rd[dt]['grad_name']})")
    log(f"  [{card}] tensor_parallel: bf16 step {TP_STEPS + 1} with rank 0's model-group "
        f"all-reduces counted (the card synchronized around each): {c['calls']} calls, "
        f"{c['bytes'] / 2 ** 20:.1f} MiB, {c['ms']:.1f} ms on the host of a "
        f"{c['step_ms']:.1f} ms step")
    log(f"  [{card}] tensor_parallel: attention calls at H {r0['heads']} (one process "
        f"{one['heads']}), mlp_ln's w1 {r0['mlp_ln_w1']}; launches in step 1 "
        f"{bf['launches']}, in all {bf['launches_all']}")
    caught = tp_loss_misses(fault, TP_BF16_TOLS)
    log(f"  [{card}] tensor_parallel: planted fault (reduce_from_model dropped), bf16 step 1: "
        f"losses {r0['no_reduce']['losses']} / {r1['no_reduce']['losses']} on the two ranks "
        f"(relative {_fmt_rel(fault)} on rank 0); the step-1 check "
        f"{'fails it' if caught else 'PASSES it'}")
    nc = rd["no_copy"]
    caught_copy = nc["grad"] > TP_F32_GRAD_TOL
    log(f"  [{card}] tensor_parallel: planted fault (copy_to_model dropped), f32 step 1: "
        f"losses {r0['no_copy']['losses']} (relative "
        f"{_fmt_rel(relative(r0['no_copy']['losses'], one['f32']['losses'][:1]))}); AdamW's "
        f"first moments {nc['grad']:.2e} of the tensor's largest ({nc['grad_name']}); the "
        f"moments' check {'fails it' if caught_copy else 'PASSES it'}")
    for dt in tols:
        if (r0[dt]["losses"] != r1[dt]["losses"]
                or r0[dt]["sha_replicated"] != r1[dt]["sha_replicated"]):
            fail(f"tensor_parallel: {dt}: the two model ranks report different losses or hold "
                 "different replicated tensors")
        if r0[dt]["sha_shards"] == r1[dt]["sha_shards"] or r0[dt]["shards"] == 0:
            fail(f"tensor_parallel: {dt}: the ranks' shards are not split")
        if tp_loss_misses(rel[dt], tols[dt]):
            fail(f"tensor_parallel: {dt} losses outside the contract {tols[dt]}: {rel[dt]}")
        bound = 2 * TP_LR * (1 + 1e-4)
        if (not rd[dt]["same_keys"] or rd[dt]["share"] < TP_PARAM_SHARE
                or rd[dt]["worst"] > bound or rd[dt]["null"] > bound
                or dt == "f32" and rd[dt]["grad"] > TP_F32_GRAD_TOL):
            fail(f"tensor_parallel: {dt} whole parameters or first moments after step 1 off "
                 f"one process's: {rd[dt]}")
    if not caught or not caught_copy:
        fail(f"tensor_parallel: a planted fault passed its check: no_reduce {fault}, "
             f"no_copy {nc['grad']:.2e}")
    if r0["heads"] != [3] or one["heads"] != [6]:
        fail(f"tensor_parallel: the attention kernel ran at H {r0['heads']} (want [3])")
    if r0["mlp_ln_w1"] != [[384, 1536]]:       # a child's JSON line: shapes as lists
        fail(f"tensor_parallel: mlp_ln took w1 {r0['mlp_ln_w1']}, not the gathered (384, 1536)")
    launched = {k: bf["launches_all"].get(k, 0) for k in FLAGSHIP_COUNTERS}
    if min(launched.values()) == 0:
        fail(f"tensor_parallel: a flagship kernel did not launch under tp 2: {launched}")
    log(f"  [{card}] the tensor_parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return records, bf["launches_all"]


def stamp(what: str) -> None:
    log(f"[{time.perf_counter() - T0:.1f} s] {what} done")


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--parallel-child":
        print(PAR_CHILD + json.dumps(parallel_child(json.loads(sys.argv[2]))), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "point_dae_torch", "csrc")):
        fail(f"point_dae_torch/csrc not found next to {__file__}")
    sys.path.insert(0, root)
    from point_dae_torch.engine.pretrain import device_pipeline
    from point_dae_torch.utils import kernels
    from point_dae_torch.utils.config import ConfigDict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    log(card)
    if sys.argv[1:] == ["--parallel-readings"]:
        kernels.build()
        parallel_readings(card)
        return
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.get_num_threads()} CPU threads")

    # 2. build, with the previous EdgeConv, FPS, patchify, aggregate, scatter and chamfer designs
    # (the yardsticks of the redesigned kernels)
    from point_dae_torch.tools import (chamfer_ablation, edgeconv_ablation, fps_ablation,
                                       rowreduce_ablation)

    t0 = time.perf_counter()
    parent_join = edgeconv_ablation.build_in_background(["parent"])
    parents_join = edgeconv_ablation.build_in_background(["fps_parent", "patchify_parent"],
                                                         fps_ablation.build)
    rowreduce_join = edgeconv_ablation.build_in_background(
        ["aggregate_parent", "scatter_parent"], rowreduce_ablation.build)
    chamfer_join = edgeconv_ablation.build_in_background(["chamfer_parent"],
                                                         chamfer_ablation.build)
    logs = kernels.build()
    parent = parent_join()["parent"][0]
    parents = {name: lib for name, (lib, _) in parents_join().items()}
    parents.update({name: lib for name, (lib, _) in rowreduce_join().items()})
    parents.update({name: lib for name, (lib, _) in chamfer_join().items()})
    log(f"build: {sorted(logs)} and the previous EdgeConv, FPS, patchify, aggregate, "
        f"scatter and chamfer designs in {time.perf_counter() - t0:.1f} s")
    stamp("import and build")
    for name, text in sorted(logs.items()):
        if name == "attention":
            log_attention_build(text)
            continue
        if name == "folding":
            log_named_build("folding", text,
                            r"\d((?:fold|gemm|wide)_[a-z0-9_]*?kernel(?:ILb[01]ELb[01]E|ILi\dE)?)")
            continue
        if name == "mlp":
            log_named_build("mlp", text, r"\d(mlp_[a-z_]*?kernel(?:IL[bi]\d+EL[bi]\d+E|IL[bi]\d+E)?)")
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line.lower() and "0 bytes" not in line:
                log(f"  {name}: {line.strip()}")

    FINETUNES["C"] = (load_cfg(FINETUNE_C_CFG), 2048, True)
    config = ConfigDict(copy.deepcopy(FLAGSHIP_CONFIG))
    d = config["dataset"]["train"]["others"]
    g = torch.Generator(device=device).manual_seed(SEED)
    raw = torch.randn((BATCH, NRAW, 6), generator=g, device=device)
    _, clean = device_pipeline(raw, d["aug_type"], d["corrupt_type"], d["npoints"],
                               generator=g, device=device)
    pts = clean[..., :3].contiguous()

    import numpy as np

    dconfig = ConfigDict(copy.deepcopy(DGCNN_CONFIG))
    dd = dconfig["dataset"]["train"]["others"]
    raw_d = torch.from_numpy(np.random.default_rng(1).normal(
        size=(DGCNN_BATCH, NRAW, 6)).astype(np.float32)).to(device)
    corrupted_d, clean_d = device_pipeline(raw_d, dd["aug_type"], dd["corrupt_type"],
                                           dd["npoints"], generator=g, device=device)
    clean_d = clean_d[..., :3].contiguous()

    # 3. kernels
    log("kernels:")
    records = phase_kernels(torch, pts, device, parents)
    stamp("kernels")
    torch.cuda.empty_cache()
    records.update(phase_dgcnn_kernels(torch, corrupted_d, clean_d, device, parent, parents))
    stamp("dgcnn_kernels")
    torch.cuda.empty_cache()
    records.update(phase_fps_kernels(torch, device, parents))
    stamp("fps_kernels")
    torch.cuda.empty_cache()
    records.update(phase_scatter_kernels(torch, device, card, parents))
    stamp("scatter_kernels")
    torch.cuda.empty_cache()
    records.update(phase_key_knn_kernels(torch, device, card, parents))
    stamp("key_knn_kernels")
    torch.cuda.empty_cache()
    recs, wide_launches = phase_mlp_wide_kernels(torch, device)
    records.update(recs)
    stamp("mlp_wide_kernels")
    torch.cuda.empty_cache()
    phase_mlp_wide_c(torch, device, card)
    stamp("mlp_wide_c")
    torch.cuda.empty_cache()
    for name, r in records.items():
        log(f"  [{card}] {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}, "
            f"bound {r['bound'][0]:.4f} by {r['bound'][1]}) {r.get('note', '')}")

    # 4. check against the plain paths on the CPU
    log("check:")
    phase_check(torch, config, raw, device)
    stamp("check")
    phase_dgcnn_check(torch, dconfig, corrupted_d, clean_d, device)
    stamp("dgcnn_check")
    phase_finetune_check(torch, device)
    stamp("finetune_check")
    phase_partseg_check(torch, device)
    stamp("partseg_check")
    phase_dropout_maskfeat_check(torch, raw_d, device)
    stamp("dropout_maskfeat_check")
    torch.cuda.empty_cache()
    phase_memory_check(torch, config, dconfig, raw, corrupted_d, clean_d, device)
    stamp("memory_check")
    torch.cuda.empty_cache()

    # 5. train
    log("train:")
    launches, default = phase_train(torch, config, raw, device, card)
    stamp("train")
    torch.cuda.empty_cache()
    log("train (memory keys):")
    launches_m = phase_memory_train(torch, config, raw, device, card, default)
    for k in ("mlp_fwd", "mlp_bwd"):
        launches[k] = launches_m[k]
    stamp("memory_train")
    del raw, pts, clean
    torch.cuda.empty_cache()
    log("train (DGCNN):")
    launches_d, default_d = phase_dgcnn_train(torch, dconfig, raw_d, device, card)
    stamp("dgcnn_train")
    torch.cuda.empty_cache()
    phase_dgcnn_remat(torch, dconfig, raw_d, device, card, default_d)
    stamp("dgcnn_remat")
    for k in DGCNN_COUNTERS + ("knn_aggregate_bwd_split",):
        launches[k] = launches_d[k]
    torch.cuda.empty_cache()
    launches["aggregate_from_idx"] = phase_hybrid(torch, dconfig, raw_d, corrupted_d[:32],
                                                  device, card)["aggregate_from_idx"]
    stamp("hybrid")
    torch.cuda.empty_cache()
    log("train (in-model dropouts, MaskFeat_dgcnn):")
    dm = phase_dropout_maskfeat_train(torch, raw_d, device, card)
    stamp("dropout_maskfeat_train")
    launches["key_gather"] = dm["dropout"]["key_gather"]
    launches["knn"] = dm["maskfeat"]["knn"]
    log("check (corruption families):")
    phase_corruptions_check(torch, raw_d, device)
    stamp("corruptions_check")
    torch.cuda.empty_cache()
    log("train (corruption configs, unmasked flagship):")
    phase_corrupt_train(torch, raw_d, device, card)
    stamp("corrupt_train")
    del raw_d, corrupted_d, clean_d
    torch.cuda.empty_cache()
    log("masksurf (the MaskSurf family, the dVAE tokenizer):")
    phase_masksurf(torch, device, card)
    stamp("masksurf")
    torch.cuda.empty_cache()

    # 6. the classification fine-tune entry
    log("finetune:")
    launches["fps"] = phase_finetune(torch, device, card)
    stamp("finetune")

    # 7. the part-segmentation entry
    log("partseg:")
    launches["scatter_rows_add"] = phase_partseg(torch, device, card)
    stamp("partseg")
    torch.cuda.empty_cache()

    # 8. the data and run layer through the CLI
    log("run:")
    phase_run(torch, device, card)
    stamp("run")
    torch.cuda.empty_cache()

    # 9. the Point-M2AE family and the frozen-feature probes
    log("m2ae (the Point-M2AE family):")
    phase_m2ae(torch, device, card)
    stamp("m2ae")
    torch.cuda.empty_cache()
    log("probe (the SVM and task-affinity modes through the CLI):")
    phase_probe(torch, device, card)
    stamp("probe")
    torch.cuda.empty_cache()

    # 10. 3DETR, Point-MAE, the transformer MaskFeat; the part modes and PointNet++
    log("backbones (3DETR, Point_MAE, MaskFeat_transformer):")
    phase_backbones(torch, device, card)
    stamp("backbones")
    torch.cuda.empty_cache()
    log("part modes (only_new, diff_lr, the linear probe, PointNetv2):")
    phase_part_modes(torch, device, card)
    stamp("part_modes")
    torch.cuda.empty_cache()

    # 11. the downstream modes (rotation, ModelNet-C, saliency, reconstruction) and Point_MlMAE
    log("downstream (Point_MlMAE, --so3_rotation, --test_corruption, --vis_saliency, --test):")
    phase_downstream(torch, device, card)
    stamp("downstream")
    torch.cuda.empty_cache()

    # 12. the PointNet, PointNet++ and DGCNN classes (PCN, folding and MA2E decoders)
    log("cnn zoo (the PointNet, PointNet++ and DGCNN classes):")
    phase_cnn_zoo(torch, device, card)
    stamp("cnn_zoo")
    torch.cuda.empty_cache()

    # 13. the PointCAE transformer heads, the supervised path and the optimizer keys
    log("transformer heads (the 13 PointCAE heads, supervised, LambdaLR, step_per_update, "
        "bnmscheduler):")
    phase_transformer_heads(torch, device, card)
    stamp("transformer_heads")
    torch.cuda.empty_cache()

    # 14. data parallelism: process groups, one rank a child process
    log("parallel (a group of one over nccl, two gloo ranks on the card, emd_loss):")
    phase_parallel(torch, device, card)
    stamp("parallel")
    torch.cuda.empty_cache()

    # 15. tensor parallelism: the ViT blocks split over two gloo ranks on the card
    log("tensor_parallel (get_mesh_2d, shard_params: two ranks at tp 2 on the card):")
    recs, tp_launches = phase_tensor_parallel(torch, device, card, g)
    records.update(recs)
    for way in ("fwd", "bwd"):
        launches[f"attention_{way}_h3"] = tp_launches.get(f"attention_{way}", 0)
    stamp("tensor_parallel")
    # gather_rows_wide is the one kernel without a path: the JAX package keeps
    # XLA's gather forward on purpose (point_dae_tpu/ops/pallas_scatter.py:
    # 267-276) and the port its plain one, so the rule leaves it out and its
    # launches are the kernels phase's
    on_path = {k: v for k, v in launches.items() if k != "gather_rows_wide"}
    if min(on_path.values()) == 0:
        fail(f"a kernel was never launched on its main path: {on_path}")
    launches["gather_rows_wide"] = wide_launches
    log(f"[{card}] the whole script: {time.perf_counter() - T0:.1f} s")

    out = []
    for name, r in records.items():
        out.append({"name": name, "route": "cuda", "source": r["source"],
                    "replaces": r["replaces"], "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
