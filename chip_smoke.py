#!/usr/bin/env python3
"""Drives the PyTorch port (``simhand_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

1. builds the CUDA kernels (and the host gather of the crop cache) from
   ``simhand_tpu_torch/csrc`` into ``build/``
   and prints the card's name and power limit;
2. holds each of the four NT-Xent kernels against its plain PyTorch version
   in float32 (TF32 off) at three shapes: the training step's 512 x 512, a
   512-row shard against 16384 columns, and 16384 x 16384 (8192 pairs, the
   paper's global batch on one card); denominators within rtol 1e-5,
   gradients within 1e-5 * max|G|; each (three-pass TF32 products on the
   tensor cores, column splits summed in a fixed order) also a second
   launch equal bit for bit; times each with CUDA events over back-to-back
   calls (host enqueue included) and with torch.profiler (the device time
   of its kernels alone), beside its bound and the unit that sets it
   (bytes, the tensor cores' TF32 rate or the CUDA cores' float32 rate);
3. runs the simhand_w pre-training step as ``bench.py`` builds it
   (ResNet-50, 128x128, bf16, B = 256 pairs, use_pallas=True, LARS) on a
   synthetic batch made on the card from ``--seed``: the step-0 loss and
   the gradient w.r.t. the projections must match the dense route, the
   losses must be finite, the parameters must change at step 1, kernels
   #2 and #4 must launch on every step; then img/s of the kernel route and
   of the dense route, timed in turns, one eval step, and a torch.profiler
   breakdown of three kernel-route steps with the share of their wall time
   in which the card ran no kernel (profiler on), each NT-Xent kernel's ms
   and launches a step with its sum pass, and the launches of #2, #4 and
   their sum passes required; then the production input path: a corpus of
   2,048 synthetic 224x224 crops from ``--seed`` (no cv2) written to a
   packed crop cache under ``build/``, raw batches of 256 pairs gathered
   natively by two iterator threads and prefetched through pinned buffers,
   and the same step augmenting both views on the card (crop, rotate,
   resize): finite losses, a parameter change at step 1, #2 and #4 on every
   step, an augmented eval step that gives the same loss twice; the
   composed step, the augmented step on one raw batch held on the card and
   the pre-augmented step timed in turns, the host's assembly rate, the
   pinned link, the feed alone and a profile of the composed step; the
   augmentation alone (events, device ms, top kernels) for the main path's
   flags and for every flag, each also applied on the card and on the CPU
   to one draw (the crop box exactly, the images within 0.05 on the 0-255
   scale on all but 1e-4 of their elements, the joints within 1e-3 px);
4. holds each of the four fused BN+ReLU backward kernels (#5-#8, csrc/
   bn_epilogue.cu) against its plain PyTorch version in bf16 and float32 at
   the ResNet-50 step's stem (2,097,152 x 64), layer1-bn3 (524,288 x 256)
   and layer4-bn3 (8,192 x 2,048) sites and a ragged 1,000 x 96 (#7 on g,
   x and r, #8 on the plain version's dres; #5 also with a gradient that
   is not channels-last): sums within rel 1e-5 of their largest, no mask
   differences in #7's dres, dx and dres equal bit for bit, a second
   launch of each equal bit for bit, the bulk-copy ring taken by #5-#8 at
   the three ResNet sites and the per-element walk at the ragged one (the
   CUDA source's own test, bn_ring_fits); times each (CUDA
   events, torch.profiler, the plain version, its own byte bound) and, at
   the stem (#5+#6) and at layer1-bn3 and layer4-bn3 (#7+#8), the pair's
   bound and the exact route's backward it replaces, by events and by
   torch.profiler;
5. runs the same step through the fused BN+ReLU encoder
   (bn_fused="epilogue"): its step-0 loss must equal bn_fused=
   "epilogue_xla"'s bit for bit and the exact route's within rel 5e-4, its
   gradients must agree with epilogue_xla's; five steps with finite losses
   and parameters that change, kernels #5/#6 launched 33 times and #7/#8
   16 times per step, #2/#4 once, every launch of #5-#8 in step 0 on the
   ring; the exact, epilogue and epilogue_xla routes timed in turns, one
   eval step, a torch.profiler breakdown with each of #5-#8's device ms and
   launches per step (sum passes included; #6 and #8 told apart by their
   template argument) beside its bound over the step's own sites, and #5
   and #6 timed alone at each distinct site;
6. holds the plain family's (simhand-base) step-0 loss and dL/dprojections
   against its dense route on the same projections (rel 1e-4; 1e-3 of the
   largest), runs two steps, which must launch kernels #1 and #3 on every
   step, and profiles three: #1's and #3's ms and launches a step, each
   with its sum pass, the launches required;
7. holds kernel #9 (the two reduces of the plain BatchNorm backward,
   csrc/bn_epilogue.cu) against its plain version in bf16 and float32 at the
   sites of phase 4, also with a gradient that is not channels-last (the
   wrapper copies it): sums within rel 1e-5 of their largest, a second
   launch equal bit for bit, the ring taken at the three ResNet sites and
   the walk at the ragged one; times it (CUDA events, torch.profiler, the
   plain version, the byte bound) beside torch.batch_norm_backward_reduce,
   one PyTorch call of the same function, by CUDA events and by
   torch.profiler: in bf16 #9's device time must be below the library's at
   the stem and layer1-bn3;
8. holds kernels #10 and #11 (the 1x1 convolution with BatchNorm
   statistics, csrc/conv1x1.cu) against their plain versions (cuBLAS in
   float32, TF32 off) at the six kinds of fused site of the ResNet-50 step,
   a ragged 1,000 x 96 -> 40 and 65,535 x 128 + 1 rows, 8 -> 8: every y
   element within one bf16 ulp (plus 2^-16 * sum |x||w| for the float32
   sums' order), s1/s2 within rel 1e-5 of the float64 sums of the kernel's
   own y and within rel 1e-3 of the plain version's, a second launch equal
   bit for bit; times each (CUDA events; torch.profiler, the main kernel
   and the column-sum pass apart; the plain version; the bound and its
   share) beside cuBLAS's x @ w.T of the same shape (events and profiler)
   and their ratio;
9. runs the step with bn_fused="pallas": its step-0 loss must equal
   bn_fused=True's bit for bit and the exact route's within rel 5e-3 (the
   reference's affine rounds A and B to bf16 at every site), its
   gradients must agree with bn_fused=True's; five steps with finite losses
   and parameters that change, kernel #9 launched 53 times per step, each
   launch of step 0 on the ring, #2/#4 once; the exact, pallas and
   bn_fused=True routes timed in turns, one eval step, a torch.profiler
   breakdown with #9's device ms and launches per step (sum passes
   included) beside its bound over the step's sites, and #9 timed alone at
   each distinct site;
10. runs the step with conv1x1_fuse_min_cin=512: its step-0 loss within rel
   5e-4 of the exact route's (its gradients against the exact route's are
   printed: a different bf16 forward, so not held to phase 5's limits); the
   fused site's output and gradients against cuDNN's conv and BatchNorm at
   three of the step's sites, each within 1e-2 of its norm; five steps as
   above with kernel #10 launched 15 times per step, #11 never, #2/#4 once;
   timed in turns with the exact route, a torch.profiler breakdown;
11. holds the convolution kernel (csrc/conv_bias.cu: a bf16 implicit GEMM
   whose float32 sum takes the bias, the residual and ReLU before one
   rounding) against its plain version at each distinct convolution of the
   serving forward (ResNet-50, 128x128, B = 256: the 7x7/2 stem, 1x1 at
   layer1, layer3 and layer4, 3x3 at layer1 and layer4, layer2_0's 3x3/2 and
   its 1x1/2 downsample, layer4's conv3 with the residual) and a ragged
   shape: every y element within one bf16 ulp plus 2^-16 * sum |x||w|, a
   second launch equal bit for bit; times it (CUDA events, torch.profiler,
   the plain version, the bound) beside bf16 cuDNN F.conv2d with the bias;
12. holds kernel #12 (one whole frozen identity bottleneck block, three
   launches of that kernel) against its plain version in bf16 at ResNet-50's
   layer4 at 128x128 and 224x224, layer3 and layer1 at 128x128 and layer2 at
   224x224 (256 images each) and the JAX test's ragged (2, 3) x 4: y within
   rtol = atol = 2e-2 and at most BLOCK_ULP_SHARE of it more than one bf16
   ulp away; times it (CUDA events, torch.profiler, the plain version, the
   bound) beside the same block through cuDNN (CUDA events and
   torch.profiler);
13. runs the frozen bf16 serving forward (ResNet-50, 128x128, B = 256, BN
   folded, random weights and BatchNorm statistics from ``--seed``), every
   convolution on the kernel of phase 11 (53 launches per forward) and
   layer4_1/2 through kernel #12 (2 per forward), with no mixed bf16 +
   float32 add in its profile: embeddings against the bf16 cuDNN walk (the
   yardstick, built here), the float32 folded walk and the model's own bf16
   eval forward; img/s of the three timed in turns, a torch.profiler
   breakdown of the kernel walk and of the cuDNN walk;
14. serves that forward through the micro-batcher on 127.0.0.1 (batch 128):
   eight concurrent requests of mixed sizes, each row equal to the direct
   forward on the same padded batch, /healthz, then requests/s of a burst
   of 256 whose every answer is checked the same way;
15. holds the float32 kernels #10 and #11 (csrc/conv1x1.cu, CUDA-core
   float32, TF32 off) against their plain versions at the six kinds of
   fused site: y within 1e-5 of its largest element, s1/s2 within rel 1e-5
   of the float64 sums of the kernel's own y, a second launch equal bit for
   bit; times each beside cuBLAS's float32 x @ w.T; then two float32 steps
   with conv1x1_fuse_min_cin=512: step-0 loss within rel 1e-5 of the float32
   exact step's, #10 launched 15 times per step.
16. right after the cache-fed phase of 3, runs the pre-training entry
   point (``simhand_tpu_torch.experiments.main.main``) in this process on
   that phase's cache, with RECIPES.md's flags at full width (simhand_w,
   linear/mpjpe/pos_neg, original joints, crop/resize/rotate, ResNet-50,
   B = 256 pairs, --device_augment --use_pallas, one epoch, train_ratio
   0.875) and its runs under build/: 8 steps, a finite epoch loss and
   contrastive_loss_val, #2 launched 8 + 1 times and #4 8 times, a
   checkpoint at step 8, no cv2 imported; its --export_torch file loads
   with strict=True into a fresh ResNet-50 and equals the encoder bit for
   bit; --resume --max_steps 2 restores step 8 bit for bit and ends at
   step 10; --fault_inject_preempt_step 3 saves step 3 and stops; --eval
   twice gives the same finite loss. Prints the entry point's ms/step and
   pairs/s over steps 2-8 (a sync only at both ends) beside phase 3's
   composed step, the run's epoch line and each checkpoint save's seconds.
17. right after 16, runs the detnet fine-tune entry point
   (``simhand_tpu_torch.finetune.train.main``) in this process at full
   width (synthetic, ResNet-50, 128x128, bf16, B = 128, 4 epochs of 2 steps,
   an evaluation every 2) under build/finetune_<seed>: every det_* part of
   every step finite, a checkpoint at step 8, no cv2 imported; its
   detnet.pth loads with strict=True into a fresh DetNet and equals the
   model bit for bit; ``finetune.evaluate.main`` gives the same metrics
   twice from the checkpoint and once from the .pth; --resume --max_steps 9
   restores step 8 bit for bit (parameters, statistics, both moments) and
   ends at step 9; then --bn_variant fused_pallas for 2 steps: kernel #9
   launched 53 times a step (its launch counter), each launch's sums within
   rel 1e-5 of its plain version on the same inputs (the fine-tune step's
   own sites), step 0's det_total (the forward's) within rel 5e-3 of the
   exact run's on the same first batch; the builder's image
   stage on the card equal to the CPU's on one batch of the same host draws;
   the downstream head (RN25DWithMLPRef, ResNet-50, float32, B = 64, 128x128)
   on the card within rel 1e-4 of its CPU forward. Prints the run's ms/step
   over steps 2-8 (a sync at both ends; with and without the evaluation and
   save inside), img/s, the composed step (feed + step) and the step on one
   batch held on the card in turns, the feed alone a batch split into the
   host builder and the image stage, and the evaluations' seconds.
18. last, the serving entry points as a user runs them, at full width
   (ResNet-50, 128x128, B = 256, serving_model's weights and statistics and
   a detnet with its own, under build/serving_<seed>): the encoder saved as
   a checkpoint directory (train/checkpoint.py) and the detnet as
   detnet.pth; ``serving.export.main`` writes five artifacts (the bf16,
   weight-only int8 and int8_compute encoders from --checkpoint; the bf16
   and int8_compute detnets from --pth; the int8_compute ones calibrated on
   phase 3's cache) and ``load_artifact`` loads each on the card. Held: the
   bf16 artifacts against the eval forwards they were exported from, rel
   1e-5 (uv equal); the weight-only artifact's embedding at min cosine >
   0.999 against the bf16 one and its file <= 0.35x; the int8_compute
   encoder on the card against the same artifact on the CPU (8 images, rel
   1e-5) and at min cosine > 0.99 against the float32 fold (TF32 off); the
   int8_compute detnet artifact against the module it was exported from
   (rel 1e-5, with cuDNN's deterministic algorithms on both, its float32
   deconvolutions otherwise sum in no fixed order), its h_map within 0.05
   of the bf16 artifact's and its d_map / l_map within 0.05 * max(1,
   max|ref|) of the bf16 eval forward's, uv / xyz / delta finite;
   ``embed.main`` over the cache at batch 256 against the artifact on the
   same crops (rel 1e-5); ``server.serve`` from the bf16 artifact in a
   thread, its answers as phase 14's. Prints each artifact's MB, export and
   load seconds, the calibration's seconds, embed's images/s, the server's
   requests/s, ms and img/s of every artifact, the eval forward and the
   kernel walk in turns, and one int8_compute forward's device ms by op
   (``_int_mm``, im2col, epilogue).
19. after 18, the mining stage and the worker-process loader. Mining
   (``simhand_tpu_torch.mining``, plain PyTorch ops on the card; no Pallas
   kernel lies on this path) at scripts/mine_scale_bench.py's cell: 100,000
   hands, keypoints uniform in [0, 1) and video ids in [0, 5,000) from
   ``--seed``, k = 1, chunks of 8,192, run twice (cold, warm) and equal bit
   for bit. Held: every index >= 0, every distance finite, no pair from one
   video, no hand paired with itself; the first 1,024 queries equal to
   ``topk_similar`` on the CPU on the same arrays bit for bit; a corpus of
   4,096 hands on the integer grid {0, 1, 2, 3} (copies of 512 poses over 64
   videos, so exact ties abound), k = 3, chunks of 1,000 / 1,536, equal to
   the CPU bit for bit; ``mining.run.main`` on an
   unpaired JSON of the first 16,384 hands (nested <video>/frame_x.jpg
   names, written under build/mining_<seed>) giving the library call's
   positives and distances. Prints cold and warm seconds, hands/s, the
   device ms of one 8,192 x 8,192 tile by kernel (torch.profiler, one query
   chunk against two database chunks) and of the pass (scaled by its
   tiles), its bound (N^2 * 21 * 7 float32
   operations of a fused pass) beside the bytes the port's route moves at
   the HBM rate, and the 2.0M corpus projected by N^2. The loader
   (``data.grain_loader.grain_batch_iterator``, raw simhand_w pairs of
   ``SyntheticHandSource(2048, side=224)`` from ``--seed``, batches of 256)
   at 0, 1, 2, 4 and 8 workers up to the host's cores, the workers' fork
   server started as mining begins: the serial epoch's samples equal
   ``raw_pair`` bit for bit, every worker count gives the same samples bit
   for bit. Prints raw pairs/s over the epoch (the workers' start included)
   and after the first batch, the first batch's seconds at each count,
   ``os.cpu_count()``, the corpus's build seconds, and the phase's seconds.
   Then the fork server and its resource tracker are stopped and waited
   for, and the run fails if any process it started is still running.
20. between 18 and 19, the encoder's last options and the data-parallel
   step (ResNet-50, 128x128, bf16, B = 256 pairs, simhand_w). Here: the
   space-to-depth stem against conv7 with ``s2d_stem_kernel``'s weights in
   float32 (TF32 off) within 1e-5 of the largest output; the bf16 step
   with each stem, 3 steps each, then timed in turns; remat against the
   same step without it under cuDNN's deterministic mode (the loss and the
   running statistics bit for bit, the gradients within 1e-5 of each
   tensor's largest), the peak memory and ms/step of both in turns; remat
   with ``conv1x1_fuse_min_cin=512`` launching #10 30 times a step (the
   forward's 15 and the recomputation's). Then, in processes of this
   script, all under one deadline and killed past it: the NCCL group at
   world size 1, where the sharded step (``make_train_step(...,
   axis=create_mesh())``) equals the single-device step bit for bit over 2
   steps, and the ranks agree on a host flag over the gloo group beside
   NCCL; then two ranks on the one card over gloo (two NCCL ranks on one
   device are tried, and NCCL's refusal printed; gloo takes the CUDA
   tensors of every collective the axis runs): the loss layer on this
   process's projections sliced to each rank (both families, both routes: the loss within rel 1e-5 of the single-device
   loss, each rank's dz within 1e-5 of the largest of the global dz, x1
   on the kernel route and x2 on the dense one, #2/#4 or #1/#3 launched
   once a rank); the whole step with cross-replica BatchNorm on the kernel
   and the dense route (3 steps: finite losses, the ranks' parameters and
   statistics equal bit for bit after each, step 0 within rel 1e-3 of one
   process's step on the global batch and of a one-process oracle of the
   same function, the head's BatchNorm per rank, #2/#4 every step); a
   float32 forward (TF32 off) of the two ranks against that oracle's, each
   rank's encoder embeddings within 3e-4 of its largest and the sharded
   loss within rel 1e-5 (per-replica BatchNorm's distance and the bf16
   forward's printed beside them); the per-replica
   statistics after a step against the mean of the serial per-shard
   forwards; 2 steps with ``conv1x1_fuse_min_cin=512`` (#10 15 times a
   step on each rank). Prints the two-rank step's ms/step, the gradient
   pmean's and the projections' all_gather's ms (two processes sharing one
   card: no scaling claim), and the phase's seconds.
21. after 19, the rest of the sharded work, in processes of this script
   under one deadline, killed past it: the NCCL group at world size 1,
   where the FSDP step (``make_fsdp_train_step``) equals the single-device
   step bit for bit over 2 steps (one rank shards nothing, and has no
   axis); then two ranks on the one card over gloo, each in turn: FSDP
   (ResNet-50, 128x128, bf16, B = 256 pairs, simhand_w, use_pallas: #2/#4
   once a rank a step on 256-row shards; 3 steps, the step-0 loss within
   rel 1e-3 of one process's step on the global batch, each rank holding
   under 0.55 of the replicated state's bytes, 3 timed steps, the gather
   and the reduce-scatter of the split leaves alone; one step with
   ``conv1x1_fuse_min_cin=512``, #10 15 times; float32 (TF32 off) against
   one process's step, each beside one process against itself with its
   pairs reversed: losses within rel 1e-5; one step, the Adam moment mu
   (0.1 x the gradient) within 0.25 of its norm; 2 steps with LARS
   unclipped, mu and nu within FSDP_F32_LARS_RTOL of their norms, which a
   control run (the split leaves' gradient norms of the pieces alone) must
   exceed); FSDP through the fused BatchNorm modes bn_fused="pallas" and
   "epilogue" (at world size 1 each also bit for bit one device's step with
   the same mode over 2 steps): 2 bf16 steps with #9 53 times, or #5/#6 33
   and #7/#8 16 times, a rank a step on the rank's rows, each launch's sums
   (#5, #7, #9) within rel 1e-5 of its plain version, the forward's and the
   backward's per-channel sums all-reduced once a site each; 2 timed steps
   and the BatchNorms' all-reduces replayed alone (their share of the
   step); one float32 step against one process's step with the same mode:
   the loss within rel 1e-5 and mu within 0.25, which a per-replica control
   (every BatchNorm on its rank's rows, no reduce) must exceed in mu; the
   data-parallel detnet step
   (ResNet-50 DetNet, 128x128, bf16, 128 images, fused_pallas: #9 53 times
   a rank a step, each launch's sums within rel 1e-5 of its plain
   version; 3 steps and 3 timed; one float32 step against the per-replica
   oracle in one process, each rank's rows through the model alone, the
   predictions concatenated, det_loss on the global batch: the parts
   within rel 1e-5, the pmean'd gradient within 2e-3 in norm and each
   tensor above 1e-3 of the largest norm within 1e-2); sharded mining at
   phase 19's cell, the replicated database (== phase 19's single-device
   result bit for bit) and the ring (the distances bit for bit, its first
   256 queries on each rank == the ring's block order on the CPU; the
   4,096-hand tie corpus's ring on the card == the same ring on the CPU),
   hands/s of each. Prints what gloo staged through the host and the
   phase's seconds.
22. after 21, the MANO side (``simhand_tpu_torch.finetune``: mano,
   create_data, train_shape_net, optimize_shape, recon, demo; no kernel of
   the record lies on it, and the phase fails if one launches), under
   build/mano_<seed> on synthetic MANO parameters from ``--seed`` at MANO's
   widths (778 vertices, 16 joints, 10 shape and 135 pose coefficients;
   a copy of tests/test_mano.py's generator, written as a pickle): the MANO
   forward on random Rodrigues poses at B = 1 and 4,096 on the card against
   the CPU (verts and joints21 within 1e-5 of the largest; ms a forward),
   and timed against a variant whose chain runs a batched product a level
   of the tree in place of the port's product a joint;
   ``create_data.main`` at its default 1,000,000 pairs (the first 4,096
   bones within rel 1e-6 of ``relative_bone_lengths`` on the CPU;
   samples/s); ``train_shape_net.main`` at B = 512 for 1,000 steps on
   ``--data_root`` (that SIK1M) and on the fly (losses finite, the last
   100 steps' mean below the first 100's, ``--out`` strict-loaded and
   equal; ms a step of the step loop: the call less a ``--steps 0``
   call's set-up); ``optimize_shape.main`` with that ShapeNet: the
   synthetic comparison at ``--n 32`` (bone-length MAE of PSO, LM and
   ShapeNet finite, PSO's first beta within 1e-4 of PSO on the CPU) and
   ``--pre_joints`` on 256 MANO joints; ``recon.main --n 8``; the demo's
   per-frame function (``demo.track_frame``) on 64 random 128x128 frames
   from phase 18's bf16 detnet artifact (exported again if absent), on the
   PSO and the ShapeNet route (xyz, uv, verts (778, 3) and beta finite;
   ``reconstruct`` on the CPU from the card's xyz and beta within 1e-5 of
   the card's verts). Prints frames/s, the ms a frame of the forward, the
   smoother, the shape step, AIK and MANO (each stage synchronized), and
   the phase's seconds. It imports no cv2.
23. after 22, the workflow checks (``simhand_tpu_torch.transfer_check``)
   under build/workflow_<seed>, no cv2 imported and no process of the
   phase left running at its end. A: the grand loop at full width
   (``run_grand_loop``): the annotation of CACHE_IMAGES synthetic 224x224
   hands written without frames, mined on the card (the mined top-1 of
   every hand == ``top1_cross_video``'s), the crop cache built with the
   mined positives, ``experiments.main`` on it at ResNet-50, B = 256
   pairs, simhand_w with RECIPES.md's flags and --color_jitter,
   --bn_variant stop_grad, --use_pallas --device_augment for two epochs
   (16 steps: finite losses, #2 and #4 launched once on every step), its
   --export_torch file; ``finetune.train.main --pretrain <export>
   --lr_strategy DLR`` on synthetic-hand (ResNet-50, B = 128,
   --bn_variant fused_pallas, 8 steps: the detnet's encoder equal to the
   export bit for bit before its first step, every det_* part of every
   step finite, #9 launched 53 times on every step); ``finetune.evaluate``
   on its checkpoint (finite metrics). Prints each stage's seconds, and a
   random-init fine-tune at the same budget beside the pretrained one. B:
   the eight experiment types at full width (ResNet-50, B = 256 pairs,
   use_pallas, the flagship weights for the weighted three) on one raw
   batch of phase 3's cache each, augmented on the card: step 0's loss and
   dL/dprojections against the dense route (rel 1e-4, 1e-3 of the
   largest), then two steps with #1/#3 (the plain five) or #2/#4 (the
   weighted three) launched once a step and no other NT-Xent kernel; then
   the entry point (``experiments.main``, -log_interval step) for two
   steps on that cache for each of the six types no earlier phase runs
   (simclr, simclr_w, peclr, peclr_w, simhand, simhand_vis): finite
   losses, the same launches a step. C: ``run_transfer_check`` at corpus
   seed 0 and B = 16 (the dense route) at the reference's cells: rn18
   120/60 random, exact and stop_grad (stop_grad's lossH below 0.98 x
   random's); rn18 60/60 simhand_w against simclr (printed); rn50 60/60
   random, exact and stop_grad (both below 0.98 x random's). Prints every
   arm's lossH_final, hm_pck, hm_pck_loose and hm_dist beside the
   reference's XLA-CPU figures on its JPEG route, each part's seconds and
   the phase's.
24. after 23, BASELINE.json's config #4 and the last tools, under
   build/config4_<seed>, no cv2 imported and no process of the phase left
   running at its end. A1: a float32 ResNet-152 ContrastiveModel from
   ``--seed`` (its running statistics moved by three train-mode forwards)
   in eval mode on 8 images at 128x128, the card (TF32 off) against the
   CPU within 1e-4 of the largest output. A2: phase 3's step at ResNet-152
   (128x128, bf16, B = 256 pairs, simhand_w, LARS, use_pallas) with exact
   BatchNorm and with stop_grad: step 0's loss and dL/dprojections against
   the dense route (rel 1e-4; 1e-3 of the largest), 3 steps with finite
   losses and a parameter change at step 1, #2 and #4 once on every step;
   both timed in turns (ms/step, pairs/s), each one's peak memory, and a
   profile of the exact step with #2/#4's device ms and launches a step
   required. A3: the same step accumulating over 4 micro-batches (no
   warmup; cuDNN deterministic): the parameters bit for bit unchanged and
   every BatchNorm running statistic moved after micro-steps 1-3, one
   update at micro-step 4; the gradient handed to it within rel 1e-5 of
   each tensor's largest element of the float32 mean of the 4 gradients
   taken separately from the same starting state; the parameters equal to
   one update of that gradient bit for bit, and to one update of the mean
   within 1e-5 of each tensor's largest update element plus lr |dg| / eps
   (Adam's first step is x / (|x| + eps), whose slope is at most 1 / eps).
   A4: ``experiments.main`` with RECIPES.md section 2's flags, ResNet-152,
   B = 256, -accumulate_grad_batches 32, --bn_variant stop_grad,
   --use_pallas, on phase 3's cache with --device_augment for 64
   micro-steps: finite losses, #2 and #4 once on every micro-step, the
   optimizer's updates at micro-steps 32 and 64 alone (8,192 pairs each),
   the parameters moving at those of them whose learning rate is not 0
   and at no other micro-step (the recipe's warmup starts at lr 0), and
   base_lr = lr * sqrt(1024 * 32). The parameters are compared after
   micro-steps 31, 32, 63 and 64 only, and the card is waited for after 1
   and 31 and around 32 and 64: ms an accumulation micro-step over 2-31,
   which hold no check and no wait, and ms of each update micro-step.
   B1: ``bn_grid.main`` at --seeds 1 --rn50_seed -1
   --pretrain_steps 20 --finetune_steps 20: two cell lines, no error line,
   the random arm on the exact cell alone; run again, it starts no cell
   and adds no line. B2: ``run_int8_quality`` at its defaults (rn18, 150
   steps, B = 16): every meter finite, fold_f32 against the eval arm within
   the JAX test's fold-parity gate (hm_pck within 1e-3, epe_mean within
   1e-5 (1 + epe_mean)); the three arms printed. B3: ``verify_release`` on
   phase 16's --export_torch file (one entry-point step exports one when
   phase 16 has not run) gives ok, and exit 1 on a copy with one tensor
   reshaped. Prints each part's seconds and the phase's.

Any failure ends the run with a non-zero exit code. The last line of the
output is ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit as ``nvidia-smi`` gives them, and the JSON
record of the kernels comes before that.
"""
from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import functools
import json
import logging
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
TF32_TENSOR_OPS_PER_S = 495e12

SOURCES = {"ntxent": "simhand_tpu_torch/csrc/ntxent.cu",
           "bn_epilogue": "simhand_tpu_torch/csrc/bn_epilogue.cu",
           "conv1x1": "simhand_tpu_torch/csrc/conv1x1.cu",
           "conv_bias": "simhand_tpu_torch/csrc/conv_bias.cu",
           # host code: the crop cache's gather, built with g++
           "batch_gather": "simhand_tpu_torch/csrc/batch_gather.cpp"}
REPLACES = {
    "ntxent_denominator": "simhand_tpu/losses/pallas_ntxent.py:76",
    "weighted_ntxent_denominator": "simhand_tpu/losses/pallas_ntxent.py:154",
    "ntxent_grad": "simhand_tpu/losses/pallas_ntxent.py:236",
    "weighted_grad_rows": "simhand_tpu/losses/pallas_ntxent.py:596",
}
BN_REPLACES = {
    "masked_dual_reduce": "simhand_tpu/models/bn_epilogue.py:127",
    "masked_dx": "simhand_tpu/models/bn_epilogue.py:162",
    "masked_dual_reduce_res": "simhand_tpu/models/bn_epilogue.py:325",
    "masked_dx_res": "simhand_tpu/models/bn_epilogue.py:342",
}
# NCHW sites of the ResNet-50 step at 128x128 and 512 images, and a ragged one
BN_SHAPES = (("stem", (512, 64, 64, 64)), ("layer1_bn3", (512, 256, 32, 32)),
             ("layer4_bn3", (512, 2048, 4, 4)), ("ragged", (8, 96, 5, 25)))
BN_MAIN_SHAPE = {"masked_dual_reduce": "stem", "masked_dx": "stem",
                 "masked_dual_reduce_res": "layer1_bn3", "masked_dx_res": "layer1_bn3"}
# launches per train step: the stem and bn1/bn2 of 16 bottlenecks; 16 bn3
BN_PER_STEP = {"masked_dual_reduce": 33, "masked_dx": 33,
               "masked_dual_reduce_res": 16, "masked_dx_res": 16}
# kernel #9 (in bn_epilogue.cu): main shape the stem; 1 stem + 16 x 3 + 4
# downsample sites per step
FUSED_BN_REPLACES = {"bn_backward_reduces": "simhand_tpu/models/fused_bn.py:182"}
FUSED_BN_PER_STEP = 53
# kernels #10/#11: the fused conv1x1+BN sites of the step at
# conv1x1_fuse_min_cin=512 as (label, M, Cin, Cout, sites per step), a
# ragged shape and one with more rows than 65,535 tiles of 128; main shape
# the most frequent site
CONV_REPLACES = {"conv1x1_stats": "simhand_tpu/ops/conv1x1.py:128",
                 "conv1x1_bn_relu_stats": "simhand_tpu/ops/conv1x1.py:133"}
CONV_SHAPES = (("layer2_conv1", 131072, 512, 128, 3), ("layer3_0_conv1", 131072, 512, 256, 1),
               ("layer3_conv1", 32768, 1024, 256, 5), ("layer4_0_conv1", 32768, 1024, 512, 1),
               ("layer4_conv1", 8192, 2048, 512, 2), ("layer4_conv3", 8192, 512, 2048, 3),
               ("ragged", 1000, 96, 40, 0), ("large_m", 65535 * 128 + 1, 8, 8, 0))
CONV_MAIN_SHAPE = "layer3_conv1"
CONV_FUSE_MIN_CIN, CONV_PER_STEP = 512, 15
# the convolution kernel at each distinct convolution of the serving forward
# (ResNet-50, 128x128, B = 256) as (label, N, H, W, Cin, Cout, kernel,
# stride, padding, relu, residual), and a ragged one; main shape the 3x3 of
# #12 (layer4)
CONV_BIAS_REPLACES = {"conv_bias_act": "simhand_tpu/ops/bottleneck_block.py:92"}
CONV_BIAS_SHAPES = (
    ("stem", 256, 128, 128, 3, 64, 7, 2, ((3, 3), (3, 3)), True, False),
    ("layer1_1x1", 256, 32, 32, 256, 64, 1, 1, "SAME", True, False),
    ("layer1_3x3", 256, 32, 32, 64, 64, 3, 1, "SAME", True, False),
    ("layer2_0_3x3s2", 256, 32, 32, 128, 128, 3, 2, "SAME", True, False),
    ("layer2_0_down", 256, 32, 32, 256, 512, 1, 2, "SAME", False, False),
    ("layer3_1x1", 256, 8, 8, 1024, 256, 1, 1, "SAME", True, False),
    ("layer4_1x1", 256, 4, 4, 2048, 512, 1, 1, "SAME", True, False),
    ("layer4_3x3", 256, 4, 4, 512, 512, 3, 1, "SAME", True, False),
    ("layer4_conv3_res", 256, 4, 4, 512, 2048, 1, 1, "SAME", True, True),
    ("ragged", 3, 9, 11, 40, 72, 3, 2, "SAME", True, True))
CONV_BIAS_MAIN_SHAPE = "layer4_3x3"
# launches per serving forward: the stem, 16 blocks x 3 and 4 downsamples
CONV_BIAS_PER_FORWARD = 53
# kernel #12: identity blocks of ResNet-50 as (label, images, (H, W), C, Cm);
# main shape layer4 of the serving forward at 128x128, B = 256
BLOCK_REPLACES = {"bottleneck_block": "simhand_tpu/ops/bottleneck_block.py:92"}
BLOCK_SHAPES = (("layer4_128", 256, (4, 4), 2048, 512), ("layer4_224", 256, (7, 7), 2048, 512),
                ("layer3_128", 256, (8, 8), 1024, 256), ("layer1_128", 256, (32, 32), 256, 64),
                ("layer2_224", 256, (28, 28), 512, 128), ("ragged_2x3", 4, (2, 3), 256, 128))
BLOCK_MAIN_SHAPE = "layer4_128"
# y against the plain version: the JAX test's rtol = atol = 2e-2, and the
# share of elements more than one bf16 ulp away (float32 sums in another
# order round an element of h1 or h2 to its other neighbour, which moves y;
# measured 0.44-0.51% at layer4 on an H100 by a one-launch design): four
# times that
BLOCK_RTOL, BLOCK_ULP_SHARE = 2e-2, 2e-2
# the serving forward: ResNet-50 at SIDE, SERVE_IMAGES images, the blocks of
# scripts/bench_block.py:64-65 through #12; the server's batch
SERVE_BLOCKS, SERVE_IMAGES, SERVE_TIMED, SERVER_BATCH = ("layer4_1", "layer4_2"), 256, 10, 128
# embeddings of the kernel walk against the cuDNN walk, relative to the
# largest: the two differ by the cuDNN walk's second rounding at every
# convolution, by conv3's rounding before the shortcut's add at two blocks
# and by the sums' order (CPU, ResNet-50 at 64x64: 3.0e-3)
SERVE_WALK_RTOL = 1e-2

# phase 18, the serving entry points: a plain artifact against the eval
# forward it was exported from, relative to the largest output (expected
# bit-equal: the same ATen ops); the int8_compute artifact on the card
# against itself on the CPU on INT8_CPU_IMAGES images (its int8 GEMMs are
# exact and its epilogue the same float64 arithmetic on both) and the
# in-memory detnet it was exported from; embed.main against the artifact.
# The weight-only artifact's min cosine and file share against the bf16
# one (tests/test_serving.py's 0.999 and 0.35); the int8_compute embedding's
# min cosine against the float32 fold (TF32 off); the int8_compute detnet
# against bf16: h_map absolute, d_map / l_map relative to max(1, max|ref|)
# (tests/test_int8_infer.py:160-168)
ARTIFACT_RTOL, INT8_CPU_IMAGES = 1e-5, 8
QUANT_MIN_COS, QUANT_SIZE_SHARE, INT8_F32_MIN_COS, DETNET_INT8_ATOL = 0.999, 0.35, 0.99, 0.05
# the int8_compute forward's device time by op: the int8 GEMMs, the im2col
# (padding, the patch concatenation, copies of strided patches), the float64
# epilogue and requantization; the rest is pooling and the projection head
INT8_OP_GROUPS = {"int_mm": ("aten::_int_mm",),
                  "im2col": ("aten::cat", "aten::constant_pad_nd", "aten::pad", "aten::clone",
                             "aten::new_zeros", "aten::reshape"),
                  "epilogue": ("aten::addcmul", "aten::add", "aten::mul", "aten::round",
                               "aten::clamp", "aten::clamp_", "aten::to", "aten::_to_copy",
                               "aten::relu")}
# float32 #10/#11 (F2): the step's fused sites, y against cuBLAS's float32
# product (TF32 off) relative to its largest element, the step-0 loss
# against the float32 exact step's, and the float32 steps run
F32_Y_RTOL, F32_LOSS_RTOL, F32_STEPS = 1e-5, 1e-5, 2
SHAPES = (("512x512", 512, 512, 0), ("512x16384", 512, 16384, 4096),
          ("16384x16384", 16384, 16384, 0))
MAIN_SHAPE = "512x512"
# each NT-Xent kernel's profile group, (name, substrings of its kernels'
# names): its main kernel and its own instance of the splits' sum pass
NTXENT_PROFILE_GROUPS = {
    "ntxent_denominator": ("ntxent_denominator", ("plain_denom_kernel", "sum_splits_kernel<1>")),
    "weighted_ntxent_denominator": ("ntxent_weighted_denominator",
                                    ("weighted_denom_kernel", "sum_splits_kernel<2>")),
    "ntxent_grad": ("ntxent_grad", ("plain_grad_kernel", "sum_splits_kernel<3>")),
    "weighted_grad_rows": ("ntxent_weighted_grad", ("weighted_grad_kernel",
                                                    "sum_splits_kernel<4>")),
}
AUGMENTATION = ("crop", "rotate", "resize")
# the step bench.py builds, at the smallest batch that takes the kernel route
RESNET, SIDE, PAIRS = "50", 128, 256
STEPS, TIMED_STEPS, PLAIN_STEPS, PROFILED_STEPS = 5, 10, 2, 3
# the cache-fed phase: a synthetic corpus of CACHE_IMAGES 224x224 crops from
# --seed in shards of CACHE_SHARD, augmented on the card with the main
# path's flags (crop, rotate, resize) into SIDE x SIDE views
CACHE_IMAGES, CACHE_SHARD, CROP = 2048, 512, 224
CACHE_STEPS, AUGMENT_ITERS, LINK_COPIES = 3, 10, 10
# the augmentation on the card against the CPU with the same draws, on the
# 0-255 scale (tests/test_torch_augment.py's WARP_TOL and CHAIN_SHARE): all
# but CHAIN_SHARE of the image elements within WARP_TOL, the crop box
# exactly, the joints within JOINT_TOL px
WARP_TOL, CHAIN_SHARE, JOINT_TOL = 0.05, 1e-4, 1e-3
# step 0 of bn_fused="epilogue" against "epilogue_xla": each parameter
# gradient relative to its norm, and all of them together
# (measured on an H100: worst 9.0e-2, the stem's bn1.bias, a sum that
# nearly cancels; all 1.7e-2). The kernels add the per-channel sums in
# another order than torch.sum, so k1 and k2 differ in their last bits, a
# bf16 dx element may round the other way, and 49 train-mode BatchNorm
# backwards carry that to the stem; epilogue_path prints the same
# comparison of the epilogue step with itself beside it.
GRAD_TENSOR_RTOL, GRAD_ALL_RTOL = 0.25, 0.05
# step 0 of bn_fused="epilogue" against the exact route (measured 5.4e-5):
# the epilogue rounds the bf16 affine twice (x*A, then +B) where cuDNN's
# BatchNorm rounds once
LOSS_EXACT_RTOL = 5e-4
# step 0 of bn_fused="pallas" against the exact route (measured 1.67e-3 on
# an H100): the reference's FusedBatchNorm rounds each channel's A and B to
# bf16 (fused_bn.py:46), a per-channel scale error of up to 2^-9 at all 53
# sites. On the CPU (scripts/torch_bf16_departure.py: ResNet-50, 96 pairs
# at 64x64, bf16) the port departs 2.3e-3 from exact with that affine and
# 2.0e-4 with one float32 rounding; exact bf16 departs 8.3e-4 from exact
# float32. The epilogue rounds the same
# way at 49 sites (5.4e-5 on the card: the departure of a single loss
# varies by far more than its cause between variants).
LOSS_TWO_ROUNDING_RTOL = 5e-3


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def counted_launches() -> dict:
    """The launches the port's wrappers have counted so far, by the names of
    the kernels they launch: each counted launch runs exactly one kernel
    whose name holds one of the names of its group (a sum pass is named
    otherwise). bottleneck_block counts nothing of its own here: its three
    launches are conv_bias_act's."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.models import fused_bn as F
    from simhand_tpu_torch.ops import conv1x1 as C
    from simhand_tpu_torch.ops import conv_bias as CB

    groups = {("plain_denom_kernel", "weighted_denom_kernel", "plain_grad_kernel",
               "weighted_grad_kernel"): K.KERNELS,
              ("bn_ring_reduce_kernel", "bn_res_reduce_kernel", "bn_ring_dx_kernel"):
                  (*E.KERNELS, *F.KERNELS),
              ("conv1x1_stats",): C.KERNELS,
              ("conv_bias_kernel",): (CB.conv_bias_act,)}
    return {names: sum(fn.launches for fn in fns) for names, fns in groups.items()}


def profiled_session(run):
    """A torch.profiler session that records run() once as a warm-up cycle,
    which it drops, and then once more: the profiler and the launch counts
    of the second run. Without the warm-up cycle a session's device records
    can come back empty or in part, and keep doing so session after session
    (seen on an H100 with torch 2.11, minutes into the process: 24 of the 30
    kernels of ten launches of #5 in every one of 12 sessions, 4 of the
    thousands of a step, 46 of the 66 launches a step of #5 and its sum
    pass); with it, 15 of 16 such sessions were whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        before = counted_launches()
        run()
        torch.cuda.synchronize()
        prof.step()
    return prof, {names: n - before[names] for names, n in counted_launches().items()}


def profiled_kernels(run, least: int = 1, tries: int = 4) -> list:
    """The CUDA kernel rows of torch.profiler's key_averages() over run()
    (profiled_session; the step annotation is not a kernel). A session is
    run again, up to ``tries`` sessions, each retry said on stderr, where it
    recorded fewer than ``least`` kernel launches, or fewer launches of the
    port's kernels than their wrappers counted in it (counted_launches);
    then the script fails."""
    from torch.autograd import DeviceType

    for attempt in range(1, tries + 1):
        prof, counted = profiled_session(run)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")]
        lost = {names[0]: (seen, n) for names, n in counted.items()
                if (seen := sum(e.count for e in kernels if any(k in e.key for k in names))) < n}
        if sum(e.count for e in kernels) >= least and sum(
                e.self_device_time_total for e in kernels) > 0 and not lost:
            return kernels
        print(f"chip_smoke: profiler session {attempt} of {tries} recorded "
              f"{sum(e.count for e in kernels)} kernel launches; of the port's kernels "
              f"(recorded, counted) {lost}", file=sys.stderr)
        time.sleep(1.0)
    raise SmokeFailure("the profiler lost device records in every session")


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Mean device time of fn() over iters calls, by kernel name: the
    torch.profiler time of the kernels it launched, without the host's
    enqueue time or the gaps."""
    def run():
        for _ in range(iters):
            fn()

    fn()
    return {e.key: e.self_device_time_total / iters / 1e3
            for e in profiled_kernels(run, least=iters)}


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls, all its kernels together."""
    return sum(device_ms_by_kernel(fn, iters).values())


def bound(name: str, m: int, n: int) -> tuple[float, str, str]:
    """Least time for float32-accurate work: the largest of the bytes (each
    input read once, each output written once) over the memory rate, the
    products on the tensor cores, three TF32 passes at 495 TFLOP/s (2 * 128
    flops a pair for a denominator, 4 * 128 for a gradient), and the rest
    on the CUDA cores at 67 TFLOP/s, per pair: exp, divide, mask and sum 3;
    the weighted kernels 21 * 7 for the joint distances (sqrt counted as
    one operation) and 4 for the weight; the gradients 2 for the (1/neg_m +
    1/neg_j) factor. Returns the ms, "bytes" or "operations", and the unit
    that bounds it: "bytes", "tensor" or "cuda cores"."""
    d, weighted, grad = 128, "weighted" in name, "grad" in name
    pairs = float(m) * n
    t_tensor = 3 * pairs * 2 * d * (2 if grad else 1) / TF32_TENSOR_OPS_PER_S
    t_cuda = pairs * (3 + (21 * 7 + 4 if weighted else 0) + (2 if grad else 0)) / FP32_OPS_PER_S
    nbytes = 4 * ((m + n) * d + m)                          # z_rows, z_cols, row_ids
    nbytes += 4 * ((m + n) * 42 + 2) if weighted else 0     # joints, [d_max, d_min]
    nbytes += 4 * (m + n) if grad else 0                    # 1/neg rows and columns
    nbytes += 4 * m * (d if grad else 1)                    # output
    t_bytes = nbytes / HBM_BYTES_PER_S
    t, unit = max((t_bytes, "bytes"), (t_tensor, "tensor"), (t_cuda, "cuda cores"))
    return t * 1e3, ("bytes" if unit == "bytes" else "operations"), unit


def kernel_phase(seed: int) -> dict:
    """Each kernel against its plain version at the three shapes."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.losses.weights import pairwise_minmax

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {name: {} for name in REPLACES}
    for label, m, n, offset in SHAPES:
        z_cols = torch.randn(n, 128, device="cuda", generator=gen)
        z_cols = z_cols / z_cols.norm(dim=1, keepdim=True)
        j_cols = torch.rand(n, 21, 2, device="cuda", generator=gen) * 128.0
        z_rows = z_cols[offset:offset + m].contiguous()
        j_rows = j_cols[offset:offset + m].contiguous()
        row_ids = torch.arange(offset, offset + m, dtype=torch.int32, device="cuda")
        col_ids = torch.arange(n, dtype=torch.int32, device="cuda")
        d_min, d_max = pairwise_minmax(j_cols, "mpjpe")
        inv_cols = 1.0 / K.ntxent_denominator_plain(z_cols, z_cols, col_ids, 0.5)
        inv_rows = inv_cols[offset:offset + m].contiguous()
        args = {
            "ntxent_denominator": (z_rows, z_cols, row_ids, 0.5),
            "weighted_ntxent_denominator": (z_rows, z_cols, j_rows, j_cols, row_ids,
                                            d_max, d_min, 0.5),
            "ntxent_grad": (z_rows, z_cols, inv_rows, inv_cols, row_ids, 0.5),
            "weighted_grad_rows": (z_rows, z_cols, j_rows, j_cols, inv_rows, inv_cols,
                                   row_ids, d_max, d_min, 0.5),
        }
        for name, a in args.items():
            kernel, plain = getattr(K, name), getattr(K, f"{name}_plain")
            got, want = kernel(*a), plain(*a)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if "grad" in name:
                limit = 1e-5 * float(want.abs().max())
                require(err <= limit, f"{name} {label}: max abs err {err} > {limit}")
            else:
                rel = float(((got - want).abs() / want.abs()).max())
                require(rel <= 1e-5, f"{name} {label}: max rel err {rel} > 1e-5")
            iters = 50 if m * n <= 512 * 16384 else 5
            ms = cuda_ms(lambda: kernel(*a), iters)
            dev_ms = device_ms(lambda: kernel(*a), iters)
            plain_ms = cuda_ms(lambda: plain(*a), max(iters // 5, 2))
            bound_ms, bound_by, unit = bound(name, m, n)
            row = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "bound_unit": unit,
                   "bound_share": bound_ms / dev_ms}
            # the column splits' sum has a fixed order
            again = kernel(*a)
            torch.cuda.synchronize()
            row["second_launch_bit_equal"] = bool(torch.equal(got, again))
            require(row["second_launch_bit_equal"],
                    f"{name} {label}: a second launch gave other bits")
            del again
            report[name][label] = row
            print(f"kernel {name} {label}: max_abs_err={err:.3e} ms={ms:.4f} "
                  f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.5f} ({unit}; {100 * bound_ms / dev_ms:.1f}% of it)")
        del args, z_cols, j_cols, z_rows, j_rows, inv_cols, inv_rows
        torch.cuda.empty_cache()
    return report


def synthetic_batch(seed: int) -> dict:
    """The batch keys of bench.py, made on the card from ``seed``."""
    import torch

    b, side = PAIRS, SIDE
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, device="cuda", generator=gen)

    def normal(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    return {
        "transformed_image1": normal(b, side, side, 3),
        "transformed_image2": normal(b, side, side, 3),
        "jitter_x_1": uniform(-10, 0, b), "jitter_x_2": uniform(-10, 0, b),
        "jitter_y_1": uniform(-10, 0, b), "jitter_y_2": uniform(-10, 0, b),
        "angle_1": uniform(-45, 45, b), "angle_2": uniform(-45, 45, b),
        "joints1_aug": uniform(0, side, b, 21, 3), "joints2_aug": uniform(0, side, b, 21, 3),
        "joints1_ori": uniform(0, 1, b, 21, 3), "joints2_ori": uniform(0, 1, b, 21, 3),
    }


def compare_routes(state, batch, cfg, what: str = "step 0"):
    """The loss and dL/dprojections of both routes from the same
    projections of a copy of the state: within rel 1e-4 and 1e-3 of the
    gradient's largest. Returns that copy, on which the caller runs the
    dense route's step 0."""
    import torch

    from simhand_tpu_torch.models import contrastive_loss_from_projections

    ref = copy.deepcopy(state)
    ref.model.train()
    images = torch.cat([batch["transformed_image1"], batch["transformed_image2"]])
    with torch.no_grad():
        proj = ref.model(images)[1]
    grads = {}
    for route, c in (("kernel", cfg), ("dense", dataclasses.replace(cfg, use_pallas=False))):
        p = proj.clone().requires_grad_()
        loss, _ = contrastive_loss_from_projections(p, batch, c)
        grads[route] = (float(loss.detach()), torch.autograd.grad(loss, p)[0])
    (lk, gk), (ld, gd) = grads["kernel"], grads["dense"]
    g_err = float((gk - gd).abs().max())
    g_max = float(gd.abs().max())
    print(f"{what} routes: loss kernel={lk:.7f} dense={ld:.7f}; "
          f"dL/dproj max abs diff {g_err:.3e} (max {g_max:.3e})")
    require(abs(lk - ld) <= 1e-4 * abs(ld), f"{what}: kernel and dense losses differ")
    require(g_err <= 1e-3 * g_max, f"{what}: kernel and dense projection gradients differ")
    return ref


def take(batch):
    """The batch itself, or the next batch of a feed (a callable)."""
    return batch() if callable(batch) else batch


def timed(step, state, batch, n: int):
    """Runs n steps on ``batch`` (or on the batches of a feed, taken inside
    the timed loop); returns the state, the last loss and s/step."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = step(state, take(batch))
    last = float(metrics["contrastive_loss"])             # waits for the card
    return state, last, (time.perf_counter() - t0) / n


def profile_steps(step, state, batch, n: int = PROFILED_STEPS) -> dict:
    """Device time by kernel over n steps (torch.profiler), and the share of
    the same steps' wall time in which the card ran no kernel. The profiler
    slows the host, which lengthens the idle time."""
    import torch

    def run():
        nonlocal state, wall
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, take(batch))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n

    wall = 0.0
    kernels = profiled_kernels(run, least=n)
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e6
    print(f"profile: {n} steps, wall {wall * 1e3:.3f} ms/step, kernels {busy * 1e3:.3f} "
          f"ms/step, device idle {100 * (1 - busy / wall):.1f}% (profiler on)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        ms = e.self_device_time_total / n / 1e3
        print(f"profile: {ms:8.3f} ms/step {100 * ms / (busy * 1e3):5.1f}%  "
              f"x{e.count // n}  {e.key[:100]}")
    # a PyTorch add computed in float32 (a bf16 tensor plus a float32 one);
    # the bf16 add's kernel is CUDAFunctor_add<c10::BFloat16>
    mixed = [e for e in kernels if "CUDAFunctor_add" in e.key and "BFloat16" not in e.key]
    out = {"profile_wall_ms": wall * 1e3, "profile_kernel_ms": busy * 1e3,
           "profile_idle_share": 1 - busy / wall,
           "profile_float_add_launches": sum(e.count for e in mixed) // n,
           "profile_float_add_ms": sum(e.self_device_time_total for e in mixed) / n / 1e3}
    # the port's kernels and their second passes, by source; the BN groups
    # match disjoint sets of kernels
    for group, names in (("ntxent", ("plain_denom_kernel", "weighted_denom_kernel",
                                     "plain_grad_kernel", "weighted_grad_kernel", "sum_splits")),
                         *NTXENT_PROFILE_GROUPS.values(),
                         ("bn_epilogue", ("bn_ring_reduce", "bn_ring_dx", "bn_res_",
                                          "bn_sum_ctas")),
                         *BN_PROFILE_GROUPS.values(),
                         *((f"bn_sum_{k}", (f"bn_sum_ctas_kernel<{k}>",))
                           for k in BN_SUM_PASS.values()),
                         ("conv1x1", ("conv1x1_",)),
                         ("conv1x1_sum", ("conv1x1_sum_partials",)),
                         ("conv_bias", ("conv_bias_kernel",))):
        mine = [e for e in kernels if any(k in e.key for k in names)]
        ms = sum(e.self_device_time_total for e in mine) / n / 1e3
        launches = sum(e.count for e in mine) // n
        print(f"profile: {group} kernels {ms:.4f} ms/step ({launches} launches/step)")
        out[f"profile_{group}_ms"], out[f"profile_{group}_launches"] = ms, launches
    return out


def step_config(**kw):
    """The configuration of the step bench.py builds (simhand_w, kernel route)."""
    from simhand_tpu_torch.models import ContrastiveConfig

    return ContrastiveConfig(**{**dict(experiment_type="simhand_w", augmentation=AUGMENTATION,
                                       image_side=float(SIDE), use_pallas=True), **kw})


def new_state(seed: int, dtype=None, opt: dict | None = None, resnet: str = RESNET,
              **model_kw):
    """A ResNet-50 (or ``resnet``) ContrastiveModel computing in dtype (bf16
    by default; with the encoder options model_kw) and its train state (the
    optimizer's settings overridden by opt), initialised from seed on the
    card."""
    import torch

    from simhand_tpu_torch.models import ContrastiveModel
    from simhand_tpu_torch.train import OptimizerConfig, create_train_state

    model = ContrastiveModel(resnet, dtype=dtype or torch.bfloat16, **model_kw)
    opt_cfg = OptimizerConfig(**{**dict(train_iters_per_epoch=1000, epochs=100,
                                        warmup_epochs=10), **(opt or {})})
    return create_train_state(model, opt_cfg, seed, input_shape=(2, SIDE, SIDE, 3),
                              device="cuda")


def run_steps(step, state, batch, what: str, handles=(), steps: int = STEPS):
    """``steps`` train steps: finite losses, a parameter change at step 1;
    the hooks of ``handles`` are removed after step 0."""
    import torch

    losses = []
    for i in range(steps):
        before = [p.detach().clone() for p in state.params] if i == 1 else None
        state, metrics = step(state, take(batch))
        losses.append(float(metrics["contrastive_loss"]))
        if before is not None:
            require(any(not torch.equal(p, q) for p, q in zip(before, state.params)),
                    f"no parameter of the {what} model changed at step 1")
            del before
        if i == 0:
            for h in handles:
                h.remove()
    require(all(math.isfinite(v) for v in losses), f"non-finite {what} loss {losses}")
    return state, losses


def in_turns(steps: dict, states: dict, batch, order, n: int = TIMED_STEPS) -> tuple[dict, dict]:
    """Times n steps of each route in the given order; returns the mean
    ms/step of each and the blocks, and leaves the stepped states in
    ``states``."""
    times = {k: [] for k in steps}
    for route in order:
        states[route], last, dt = timed(steps[route], states[route], batch, n)
        require(math.isfinite(last), f"non-finite {route} loss")
        times[route].append(dt * 1e3)
    return {k: sum(v) / len(v) for k, v in times.items()}, times


def main_path(seed: int):
    """The simhand_w step at B = 256 pairs, as bench.py builds it."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.train import make_eval_step, make_train_step

    state, cfg = new_state(seed), step_config()
    batch = synthetic_batch(seed)
    ref = compare_routes(state, batch, cfg)
    steps = {"kernel": make_train_step(state.model, cfg),
             "dense": make_train_step(ref.model, dataclasses.replace(cfg, use_pallas=False))}
    ref, dense_loss, _ = timed(steps["dense"], ref, batch, 1)

    K.reset_launches()
    state, losses = run_steps(steps["kernel"], state, batch, "kernel-route")
    states = {"kernel": state, "dense": ref}
    mean_ms, blocks = in_turns(steps, states, batch, ("kernel", "dense", "dense", "kernel"))
    eval_loss = float(make_eval_step(state.model, cfg)(state, batch)["contrastive_loss"])
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}

    print(f"main path losses: {losses}, then {2 * TIMED_STEPS} timed steps; eval {eval_loss}")
    require(math.isfinite(eval_loss), "non-finite eval loss")
    require(abs(losses[0] - dense_loss) <= 1e-4 * abs(dense_loss),
            f"step-0 loss {losses[0]} differs from the dense route's {dense_loss}")
    n_train = STEPS + 2 * TIMED_STEPS
    require(launches["weighted_ntxent_denominator"] == n_train + 1,
            f"weighted denominator launches {launches}")
    require(launches["weighted_grad_rows"] == n_train, f"weighted grad launches {launches}")
    print(f"main path launches {launches}")
    del ref, states

    step_ms, dense_ms = mean_ms["kernel"], mean_ms["dense"]
    perf = {"step0_loss": losses[0], "pairs_per_step": PAIRS, "step_ms": step_ms,
            "img_per_s": PAIRS / step_ms * 1e3,
            "dense_step_ms": dense_ms, "dense_img_per_s": PAIRS / dense_ms * 1e3,
            "step_ms_blocks": blocks}
    print(f"main path: kernel route {step_ms:.2f} ms/step, {PAIRS / step_ms * 1e3:.1f} img/s; "
          f"dense route {dense_ms:.2f} ms/step, {PAIRS / dense_ms * 1e3:.1f} img/s (img = one "
          f"pair, as bench.py counts; blocks {blocks})")
    perf.update(profile_steps(steps["kernel"], state, batch))
    # the loss's kernels a step: #2 and #4 over the 2 * PAIRS rows, each with
    # its splits' sum pass when their planner splits the columns
    want = 2 * ntxent_launches_a_step("weighted_grad_rows")
    require(perf["profile_ntxent_launches"] == want,
            f"the profile counts {perf['profile_ntxent_launches']} NT-Xent launches a "
            f"step, not {want} (#2, #4 and their sum passes)")
    return state, batch, launches, perf


def augment_flag_sets():
    from simhand_tpu_torch.data.augment_cv2 import AugmentFlags

    every = {f.name: True for f in dataclasses.fields(AugmentFlags)}
    return {"main": AugmentFlags(**{k: True for k in AUGMENTATION}),
            "all": AugmentFlags(**every)}


def augment_on_card_vs_cpu(raw: dict, flags, params, seed: int) -> dict:
    """One draw on the card, applied on the card and (copied) on the CPU:
    the crop box and angle exactly, the joints within JOINT_TOL px, the
    images within WARP_TOL on the 0-255 scale on all but CHAIN_SHARE of
    their elements. Returns the share past WARP_TOL and the largest
    differences."""
    import torch

    from simhand_tpu_torch.data import augment as A

    draws = A.sample_views(A.seeded_generator("cuda", seed), raw, flags, A.AugmentParams(),
                           SIDE)
    out = {"share_past_tol": 0.0, "max_image_diff": 0.0, "max_joint_diff": 0.0}
    norm = 255.0 * min(A.IMAGENET_STD)
    for v, d in zip((1, 2), draws):
        cpu_d = A.AugmentDraws(*(None if t is None else t.cpu() for t in d))
        img, joints = raw[f"image{v}"], raw[f"joints{v}"]
        got = A.apply_augment(img, joints, d, flags, params, SIDE)
        want = A.apply_augment(img.cpu(), joints.cpu(), cpu_d, flags, params, SIDE)
        box = A.warp_box(joints.float(), d, flags, params, img.shape[1:3], SIDE)
        cpu_box = A.warp_box(joints.cpu().float(), cpu_d, flags, params, img.shape[1:3], SIDE)
        for name in ("angle", "origin", "side", "jitter"):
            require(torch.equal(getattr(box, name).cpu(), getattr(cpu_box, name)),
                    f"augmentation view {v}: the card's {name} differs from the CPU's")
        diff = (got.images.cpu() - want.images).abs() * norm
        jdiff = float((got.joints.cpu() - want.joints).abs().max())
        out["share_past_tol"] = max(out["share_past_tol"], float((diff > WARP_TOL).double().mean()))
        out["max_image_diff"] = max(out["max_image_diff"], float(diff.max()))
        out["max_joint_diff"] = max(out["max_joint_diff"], jdiff)
    require(out["share_past_tol"] <= CHAIN_SHARE and out["max_joint_diff"] <= JOINT_TOL,
            f"augmentation on the card against the CPU: {out}")
    return out


def link_gbps(nbytes: int) -> float:
    """Host-to-card GB/s of one pinned buffer of nbytes, by CUDA events over
    LINK_COPIES non_blocking copies after a warm-up."""
    import torch

    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), LINK_COPIES)
    return nbytes / ms / 1e6


def cache_fed_path(seed: int, state, pre_batch) -> dict:
    """The production input path: a synthetic corpus in a packed crop cache
    (built here, without cv2), raw pair batches by the native gather,
    prefetched onto the card, and the simhand_w step augmenting both views
    there. Checks as main_path's (finite losses, a parameter change at step
    1, #2 and #4 on every step) and a repeatable eval step; then the
    composed step timed in turns with main_path's pre-augmented step on the
    same model, the host's assembly rate, the link, the profiled step, and
    the augmentation alone and on the card against the CPU."""
    import torch

    from simhand_tpu_torch import native
    from simhand_tpu_torch.data import augment as A
    from simhand_tpu_torch.data.cache import CachedHand100MSource, build_crop_cache
    from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
    from simhand_tpu_torch.data.prefetch import device_prefetch
    from simhand_tpu_torch.data.sources import SyntheticHandSource
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.train import make_eval_step, make_train_step

    perf = {}
    t0 = time.perf_counter()
    corpus = SyntheticHandSource(CACHE_IMAGES, side=CROP, seed=seed)
    perf["corpus_s"] = time.perf_counter() - t0
    cache_dir = native.BUILD_DIR / f"cache_fed_{seed}"
    t0 = time.perf_counter()
    build_crop_cache(corpus, str(cache_dir), shard_size=CACHE_SHARD)
    perf["cache_write_s"] = time.perf_counter() - t0
    del corpus
    flags, params = augment_flag_sets()["main"], A.AugmentParams()
    dataset = PretrainDataset(CachedHand100MSource(str(cache_dir)), "simhand_w", flags, params)
    per_epoch = len(dataset) // PAIRS

    t0 = time.perf_counter()
    n = sum(len(b["image1"]) for b in batch_iterator(dataset, PAIRS, seed=seed, raw=True))
    perf["host_pairs_per_s"] = n / (time.perf_counter() - t0)
    raw_bytes = 2 * PAIRS * CROP * CROP * 3
    perf["link_pinned_gbps"] = link_gbps(raw_bytes)
    print(f"cache-fed: {CACHE_IMAGES} crops at {CROP}x{CROP} (corpus {perf['corpus_s']:.1f} s, "
          f"cache {perf['cache_write_s']:.1f} s, {CACHE_IMAGES // CACHE_SHARD} shards); host "
          f"assembly {perf['host_pairs_per_s']:.1f} pairs/s (gather, no device work); link "
          f"{perf['link_pinned_gbps']:.2f} GB/s pinned ({raw_bytes / 1e6:.1f} MB a batch)")

    def epochs():
        epoch = 0
        while True:
            yield from batch_iterator(dataset, PAIRS, seed=seed, epoch=epoch, raw=True)
            epoch += 1

    source = epochs()
    feed = device_prefetch(source)
    cfg = step_config()
    augment = (flags, params, SIDE)
    composed = make_train_step(state.model, cfg, augment=augment)
    # the composed step, the same step on one raw batch held on the card (no
    # feed), and main_path's step on its pre-augmented batch
    steps = {"composed": composed, "augmented": composed,
             "pre_augmented": make_train_step(state.model, cfg)}
    batches = {"composed": lambda: next(feed), "pre_augmented": pre_batch}
    try:
        K.reset_launches()
        state, losses = run_steps(steps["composed"], state, batches["composed"], "cache-fed",
                                  steps=CACHE_STEPS)
        raw = batches["augmented"] = next(feed)
        evaluate = make_eval_step(state.model, cfg, augment=augment)
        evals = [float(evaluate(state, raw)["contrastive_loss"]) for _ in range(2)]
        times = {k: [] for k in steps}
        order = ("composed", "augmented", "pre_augmented", "pre_augmented", "augmented",
                 "composed")
        for route in order:
            state, last, dt = timed(steps[route], state, batches[route], TIMED_STEPS)
            require(math.isfinite(last), f"non-finite {route} loss")
            times[route].append(dt * 1e3)
        launches = {fn.__name__: fn.launches for fn in K.KERNELS}
        n_train = CACHE_STEPS + len(order) * TIMED_STEPS
        print(f"cache-fed losses {losses}; eval {evals}; launches {launches}")
        require(evals[0] == evals[1] and math.isfinite(evals[0]),
                f"the augmented eval step is not repeatable: {evals}")
        require(launches["weighted_ntxent_denominator"] == n_train + 2
                and launches["weighted_grad_rows"] == n_train,
                f"#2/#4 did not launch on every cache-fed step: {launches}")
        perf.update({"losses": losses, "eval_loss": evals[0], "launches": launches})
        for route, blocks in times.items():
            ms = sum(blocks) / len(blocks)
            perf[f"{route}_ms"], perf[f"{route}_pairs_per_s"] = ms, PAIRS / ms * 1e3
            perf[f"{route}_ms_blocks"] = blocks
        print(f"cache-fed: composed step {perf['composed_ms']:.2f} ms, "
              f"{perf['composed_pairs_per_s']:.1f} pairs/s; on one raw batch on the card "
              f"{perf['augmented_ms']:.2f} ms; pre-augmented step "
              f"{perf['pre_augmented_ms']:.2f} ms, {perf['pre_augmented_pairs_per_s']:.1f} "
              f"pairs/s (in turns: {times})")
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            next(feed)
        torch.cuda.synchronize()
        perf["feed_alone_ms"] = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        print(f"cache-fed: the feed alone (gather, pinned copy, H2D; no step) "
              f"{perf['feed_alone_ms']:.2f} ms a batch")
        prof = profile_steps(steps["composed"], state, batches["composed"])
        perf.update({f"composed_{k}": v for k, v in prof.items()
                     if k in ("profile_wall_ms", "profile_kernel_ms", "profile_idle_share",
                              "profile_ntxent_launches")})
    finally:
        feed.close()
        source.close()

    for label, fl in augment_flag_sets().items():
        gen = A.seeded_generator("cuda", seed)

        def run(fl=fl, gen=gen):
            return A.prepare_views(raw, gen, fl, params, SIDE)

        perf[f"augment_{label}_ms"] = cuda_ms(run, AUGMENT_ITERS)
        by_kernel = device_ms_by_kernel(run, AUGMENT_ITERS)
        perf[f"augment_{label}_device_ms"] = sum(by_kernel.values())
        for key, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"augmentation ({label}): {ms:8.4f} ms  {key[:100]}")
        perf[f"augment_{label}_vs_cpu"] = augment_on_card_vs_cpu(raw, fl, params, seed)
        print(f"augmentation ({label} flags, both views of {PAIRS} pairs, {CROP}->{SIDE}): "
              f"{perf[f'augment_{label}_ms']:.3f} ms, device "
              f"{perf[f'augment_{label}_device_ms']:.3f} ms; on the card against the CPU "
              f"{perf[f'augment_{label}_vs_cpu']}")
    perf["augment_share_of_composed_kernels"] = (
        perf["augment_main_device_ms"] / perf["composed_profile_kernel_ms"])
    return perf


class LogLines(logging.Handler):
    """Keeps the messages of the records it is given."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def entry_point_path(seed: int, composed_ms: float) -> tuple[dict, dict]:
    """The pre-training entry point, in this process, on cache_fed_path's
    cache at full width: the training run (with the export), a resume, a
    preemption drill under another experiment name and two evaluations.
    Returns its perf record and the launches of #2 and #4 in the training
    run."""
    import importlib
    import os
    import shutil

    import torch

    from simhand_tpu_torch import constants, native
    from simhand_tpu_torch.experiments import config as cfg
    from simhand_tpu_torch.experiments import main as entry
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models.resnet import RESNETS
    from simhand_tpu_torch.train.checkpoint import CheckpointManager

    base = native.BUILD_DIR / f"entry_point_{seed}"
    shutil.rmtree(base, ignore_errors=True)
    os.environ["BASE_PATH"] = str(base)
    importlib.reload(constants)
    export = base / "resnet50_simhand.pth"
    argv = ["--experiment_type", "simhand_w", "--weight_type", "linear", "--diff_type", "mpjpe",
            "--pos_neg", "pos_neg", "--joints_type", "original", "--crop", "--resize",
            "--rotate", "-sources", "synthetic",
            "--cache_dir", str(native.BUILD_DIR / f"cache_fed_{seed}"), "--device_augment",
            "--use_pallas", "-batch_size", str(PAIRS), "-resnet_size", RESNET, "-epochs", "1",
            "-train_ratio", "0.875", "-seed", str(seed)]
    tp = cfg.update_train_params(entry.get_general_args(argv),
                                 cfg.read_json(cfg.TRAINING_CONFIG_PATH))
    name = cfg.prepare_name("simhand_w_", tp)
    steps = CACHE_IMAGES // PAIRS

    marks, saves, metrics, eval_losses = {}, [], {}, []
    real_make, real_save = entry.make_train_step, CheckpointManager.save
    real_log, real_eval = entry.MetricLogger.log_metrics, entry.make_eval_step

    # the train step, timed from step 2 to the last step of the first run
    def timing_make(*a, **k):
        step = real_make(*a, **k)
        calls = [0]

        def timed_step(state, batch):
            calls[0] += 1
            if calls[0] == 2:
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            out = step(state, batch)
            if calls[0] == steps:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
            return out

        return timed_step

    def recording_eval(*a, **k):
        evaluate = real_eval(*a, **k)

        def recorded(state, batch):
            out = evaluate(state, batch)
            eval_losses.append(out["contrastive_loss"])
            return out

        return recorded

    def timing_save(self, step, state, m):
        t0 = time.perf_counter()
        wrote = real_save(self, step, state, m)
        if wrote:
            saves.append((step, time.perf_counter() - t0))
        return wrote

    def recording_log(self, m, step):
        metrics.update({k: float(v) for k, v in m.items()})
        return real_log(self, m, step)

    lines = LogLines()
    log = logging.getLogger("simhand_tpu_torch")
    log.addHandler(lines)
    entry.make_train_step, CheckpointManager.save = timing_make, timing_save
    entry.MetricLogger.log_metrics, entry.make_eval_step = recording_log, recording_eval
    try:
        K.reset_launches()
        state = entry.main(argv + ["--export_torch", str(export)])
        launches = {fn.__name__: fn.launches for fn in K.KERNELS}
        ms = (marks["t1"] - marks["t0"]) / (steps - 1) * 1e3
        epoch_line = next(line for line in lines.lines if line.startswith("epoch 0:"))
        train_saves, train_metrics = list(saves), dict(metrics)
        ckpt = base / "saved_models" / name / "checkpoints"
        print(f"entry point: {epoch_line}; launches {launches}; metrics {train_metrics}")
        require(state.step == steps, f"the entry point ran {state.step} steps, not {steps}")
        require(all(math.isfinite(train_metrics[k]) for k in ("contrastive_loss_epoch",
                                                               "contrastive_loss_val")),
                f"non-finite entry-point losses {train_metrics}")
        require(launches["weighted_ntxent_denominator"] == steps + 1
                and launches["weighted_grad_rows"] == steps,
                f"#2/#4 launches in the entry point's run: {launches}")
        require(CheckpointManager(str(ckpt)).all_steps() == [steps],
                f"no checkpoint at step {steps} under {ckpt}")
        require(sys.modules.get("cv2") is None, "the entry point imported cv2")
        sd = torch.load(export, weights_only=True)
        fresh = RESNETS[RESNET]()
        fresh.load_state_dict(sd, strict=True)
        enc = {k: v for k, v in state.model.encoder.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        require(sd.keys() == enc.keys() and all(torch.equal(sd[k], enc[k].cpu()) for k in sd),
                "the exported encoder differs from the state's")

        real_restore = CheckpointManager.restore

        def equal_to_trained(self, st, step=None):
            out = real_restore(self, st, step)
            got, want = out.model.state_dict(), state.model.state_dict()
            require(all(torch.equal(got[k], want[k]) for k in want)
                    and all(torch.equal(a, b) for a, b in zip(
                        out.optimizer.state_dict()["mu"] + out.optimizer.state_dict()["nu"],
                        state.optimizer.mu + state.optimizer.nu))
                    and out.step == steps,
                    "the resumed state differs from the saved one")
            marks["restored"] = out.step
            return out

        CheckpointManager.restore = equal_to_trained
        try:
            resumed = entry.main(argv + ["--resume", "--max_steps", "2"])
        finally:
            CheckpointManager.restore = real_restore
        require(marks.get("restored") == steps and resumed.step == steps + 2,
                f"resume: restored {marks.get('restored')}, ended at {resumed.step}")
        del resumed
        preempted = entry.main(argv + ["--fault_inject_preempt_step", "3",
                                       "-experiment_name", "entry_preempt"])
        pre_ckpt = base / "saved_models" / "entry_preempt" / "checkpoints"
        require(preempted.step == 3 and CheckpointManager(str(pre_ckpt)).all_steps() == [3],
                f"preemption drill: step {preempted.step}")
        del preempted
        evals = []
        for _ in range(2):
            eval_losses.clear()
            entry.main(argv + ["--eval"])
            evals.append([float(v) for v in eval_losses])
        require(evals[0] == evals[1] and len(evals[0]) == steps
                and all(math.isfinite(v) for v in evals[0]),
                f"the entry point's evaluation is not repeatable: {evals}")
    finally:
        entry.make_train_step, CheckpointManager.save = real_make, real_save
        entry.MetricLogger.log_metrics, entry.make_eval_step = real_log, real_eval
        log.removeHandler(lines)

    perf = {"steps": steps, "step_ms": ms, "pairs_per_s": PAIRS / ms * 1e3,
            "composed_step_ms": composed_ms, "epoch_line": epoch_line,
            "epoch_loss": train_metrics["contrastive_loss_epoch"],
            "val_loss": train_metrics["contrastive_loss_val"],
            "eval_loss": float(sum(evals[0]) / len(evals[0])),
            "save_s": [s for _, s in train_saves], "saves": saves, "launches": launches}
    print(f"entry point: {ms:.2f} ms/step, {PAIRS / ms * 1e3:.1f} pairs/s over steps 2-{steps} "
          f"(syncs at both ends only); phase 3's composed step {composed_ms:.2f} ms; "
          f"checkpoint saves {[(st, round(sec, 3)) for st, sec in saves]} s; eval "
          f"{perf['eval_loss']}")
    del state
    return perf, launches


# the fine-tune phase: finetune.train at full width (ResNet-50, 128x128, bf16)
# on FT_BATCH synthetic samples a step, FT_EPOCHS epochs of 2 steps, an
# evaluation every FT_EVAL_EVERY epochs; the step-0 loss of
# --bn_variant fused_pallas against the exact run's (PERF.md section 2's
# limit for bn_fused="pallas" against exact); the downstream head at B =
# FT_HEAD_BATCH on the card against its CPU forward
FT_BATCH, FT_EPOCHS, FT_EVAL_EVERY, FT_TURNS, FT_HEAD_BATCH = 128, 4, 2, 2, 64
FT_HEAD_RTOL = 1e-4
FT_VAL = 64            # the trainer's synthetic val set


def finetune_path(seed: int) -> tuple[dict, dict]:
    """The detnet fine-tune and evaluation entry points in this process at
    full width, their runs under build/finetune_<seed>: the exact run (its
    export, a resume), the fused_pallas run with kernel #9, the image stage
    on the card against the CPU, two evaluations of the checkpoint and one
    of the export, and the downstream head on the card against the CPU.
    Returns its perf record and #9's launches in the fused_pallas run."""
    import os
    import shutil

    import numpy as np
    import torch

    from simhand_tpu_torch import native
    from simhand_tpu_torch.finetune import datasets as D
    from simhand_tpu_torch.finetune import evaluate as fe
    from simhand_tpu_torch.finetune import image_stage as S
    from simhand_tpu_torch.finetune import train as ft
    from simhand_tpu_torch.finetune.detnet import DetNet
    from simhand_tpu_torch.models import fused_bn as FB
    from simhand_tpu_torch.models.heads import RN25DWithMLPRef
    from simhand_tpu_torch.train.checkpoint import CheckpointManager
    from simhand_tpu_torch.train.state import init_weights

    base = native.BUILD_DIR / f"finetune_{seed}"
    shutil.rmtree(base, ignore_errors=True)
    out, pallas_out = str(base / "exact"), str(base / "fused_pallas")
    argv = ["--dataset", "synthetic", "--backbone", RESNET, "--batch_size", str(FT_BATCH),
            "--epochs", str(FT_EPOCHS), "--eval_every", str(FT_EVAL_EVERY)]
    steps = FT_EPOCHS * 2
    dev = torch.device("cuda")

    marks, parts_log, evals, saves = {}, [], [], []
    real_make, real_eval, real_save = (ft.make_detnet_train_step, ft.evaluate_detnet,
                                       CheckpointManager.save)

    def timing_make(*a, **k):
        step = real_make(*a, **k)
        calls = [0]

        def timed_step(state, batch):
            calls[0] += 1
            if calls[0] == 2:
                torch.cuda.synchronize()
                marks["t0"] = time.perf_counter()
            state, parts = step(state, batch)
            parts_log.append({k: float(v) for k, v in parts.items()})
            if calls[0] == steps:
                torch.cuda.synchronize()
                marks["t1"] = time.perf_counter()
            return state, parts

        return timed_step

    def timing_eval(*a, **k):
        t0 = time.perf_counter()
        metrics = real_eval(*a, **k)
        evals.append((time.perf_counter() - t0, metrics))
        return metrics

    def timing_save(self, step, state, m):
        t0 = time.perf_counter()
        wrote = real_save(self, step, state, m)
        if wrote:
            saves.append((step, time.perf_counter() - t0))
        return wrote

    ft.make_detnet_train_step, ft.evaluate_detnet = timing_make, timing_eval
    CheckpointManager.save = timing_save
    try:
        state = ft.main(argv + ["--out_dir", out])
        window_evals = [s for s, _ in evals]
        window_saves = [s for st, s in saves if 2 <= st < steps]
        run_ms = (marks["t1"] - marks["t0"]) / (steps - 1) * 1e3
        step_ms = ((marks["t1"] - marks["t0"] - sum(window_evals[:-1]) - sum(window_saves))
                   / (steps - 1) * 1e3)
        exact_loss0 = parts_log[0]["det_total"]
        require(state.step == steps and len(parts_log) == steps,
                f"the fine-tune run took {state.step} steps, not {steps}")
        require(all(math.isfinite(v) for p in parts_log for v in p.values()),
                f"non-finite det_* parts {parts_log}")
        ckpt = CheckpointManager(os.path.join(out, "checkpoints"), metric="det_total")
        require(ckpt.all_steps() == [steps], f"checkpoints {ckpt.all_steps()}, not [{steps}]")
        require(sys.modules.get("cv2") is None, "the fine-tune run imported cv2")
        sd = torch.load(os.path.join(out, "detnet.pth"), weights_only=True)
        fresh = DetNet(RESNET, dtype=torch.bfloat16)
        fresh.load_state_dict(sd, strict=True)
        live = {k: v for k, v in state.model.state_dict().items()
                if not k.endswith("num_batches_tracked")}
        require(sd.keys() == live.keys() and all(torch.equal(sd[k], live[k].cpu()) for k in sd),
                "the exported detnet differs from the trained one")
        print(f"fine-tune: {steps} steps, det_total {[p['det_total'] for p in parts_log]}; "
              f"evals {[(round(s, 3), m) for s, m in evals]}; saves {saves}")

        # evaluation main: the checkpoint twice, the export once
        t0 = time.perf_counter()
        ev = [fe.main(["--dataset", "synthetic", "--backbone", RESNET,
                       "--checkpoint", os.path.join(out, "checkpoints")]) for _ in range(2)]
        eval_main_s = (time.perf_counter() - t0) / 2
        ev.append(fe.main(["--dataset", "synthetic", "--backbone", RESNET,
                           "--pretrain", os.path.join(out, "detnet.pth")]))
        require(ev[0] == ev[1] == ev[2] and all(math.isfinite(v) for v in ev[0].values()
                                                if isinstance(v, float)),
                f"the evaluations differ: {ev}")

        # --resume: the state of step `steps` restored bit for bit, one more step
        real_restore = CheckpointManager.restore

        def equal_to_trained(self, st, step=None):
            got = real_restore(self, st, step)
            a, b = got.model.state_dict(), state.model.state_dict()
            moments = zip(got.optimizer.mu + got.optimizer.nu,
                          state.optimizer.mu + state.optimizer.nu)
            require(all(torch.equal(a[k], b[k]) for k in b)
                    and all(torch.equal(x, y) for x, y in moments)
                    and got.step == steps and got.optimizer.count == steps,
                    "the resumed fine-tune state differs from the saved one")
            marks["restored"] = got.step
            return got

        CheckpointManager.restore = equal_to_trained
        try:
            resumed = ft.main(argv[:-4] + ["--epochs", str(FT_EPOCHS + 1), "--eval_every", "9",
                                           "--resume", "--max_steps", str(steps + 1),
                                           "--out_dir", out])
        finally:
            CheckpointManager.restore = real_restore
        require(marks.get("restored") == steps and resumed.step == steps + 1,
                f"fine-tune resume: restored {marks.get('restored')}, ended at {resumed.step}")
        del resumed
    finally:
        ft.make_detnet_train_step, ft.evaluate_detnet = real_make, real_eval
        CheckpointManager.save = real_save

    # the composed step (feed + step) and the step on one batch held on the
    # card, in turns, from the trained state; the feed alone, split
    ds = D.SyntheticPoseDataset(n=2 * FT_BATCH, seed=0)
    builder = D.DetnetSampleBuilder(train=True)
    step_fn = ft.make_detnet_train_step(state.model)
    held = ft.to_device(next(D.detnet_batch_iterator(ds, builder, FT_BATCH, device=dev)), dev)

    def composed(n):
        it = D.detnet_batch_iterator(ds, builder, FT_BATCH, epoch=7, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step_fn(state, ft.to_device(next(it), dev))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def on_held(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step_fn(state, held)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    on_held(1)
    turns = {"composed": [], "held": []}
    for _ in range(FT_TURNS):
        turns["composed"].append(composed(2))
        turns["held"].append(on_held(3))
    host_ms, stage_ms = [], []
    for b in range(2):
        t0 = time.perf_counter()
        built = [builder.build(ds[i], np.random.default_rng([0, 9, i]))
                 for i in range(b * FT_BATCH, (b + 1) * FT_BATCH)]
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S.image_stage([f for _, f, _ in built], [d for _, _, d in built], 128, dev)
        torch.cuda.synchronize()
        stage_ms.append((time.perf_counter() - t0) * 1e3)
    # the image stage on the card against the CPU on the same host draws
    frames, draws = [f for _, f, _ in built], [d for _, _, d in built]
    on_card = S.image_stage(frames, draws, 128, dev).cpu()
    on_cpu = S.image_stage(frames, draws, 128, "cpu")
    stage_mismatch = int((on_card != on_cpu).sum())
    require(stage_mismatch == 0,
            f"the image stage on the card differs from the CPU at {stage_mismatch} values")
    del step_fn, held, state

    # the kernel route: --bn_variant fused_pallas, kernel #9 in the encoder's
    # backward, each launch held against its plain version on its own inputs
    pallas_log, site_errs = [], []
    real_launch = FB._launch

    def checked_launch(x2d, dy2d, mu, inv):
        got = real_launch(x2d, dy2d, mu, inv)
        want = FB.bn_backward_reduces_plain(x2d, dy2d, mu, inv)
        site_errs.append((tuple(x2d.shape), max(
            float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(got, want))))
        return got

    ft.make_detnet_train_step = lambda *a, **k: _logging_step(real_make(*a, **k), pallas_log)
    FB._launch = checked_launch
    try:
        FB.reset_launches()
        ft.main(argv[:-4] + ["--epochs", "1", "--eval_every", "9", "--max_steps", "2",
                             "--bn_variant", "fused_pallas", "--out_dir", pallas_out])
        launches = {fn.__name__: fn.launches for fn in FB.KERNELS}
    finally:
        ft.make_detnet_train_step = real_make
        FB._launch = real_launch
    # step 0's det_total comes out of the forward (#9 runs in the backward):
    # this holds the fused forward to the exact one, not the kernel
    pallas_rel = abs(pallas_log[0] / exact_loss0 - 1)
    sites_rel = max(e for _, e in site_errs)
    worst_site = max(site_errs, key=lambda t: t[1])[0]
    print(f"fine-tune fused_pallas: det_total {pallas_log}, step 0 rel {pallas_rel:.3e} of "
          f"exact's {exact_loss0}; launches {launches}; #9 against its plain version at each "
          f"of its {len(site_errs)} launches ({len({m for m, _ in site_errs})} distinct (M, C)): "
          f"worst rel {sites_rel:.3e} at {worst_site}")
    require(launches["bn_backward_reduces"] == FUSED_BN_PER_STEP * 2,
            f"#9 launched {launches['bn_backward_reduces']} times in 2 fine-tune steps, not "
            f"{FUSED_BN_PER_STEP * 2}")
    require(len(site_errs) == FUSED_BN_PER_STEP * 2 and sites_rel <= 1e-5,
            f"#9 on the fine-tune step: {len(site_errs)} launches checked, worst sums rel err "
            f"{sites_rel:.3e} at {worst_site} against its plain version")
    require(pallas_rel <= LOSS_TWO_ROUNDING_RTOL,
            f"fused_pallas step 0 det_total {pallas_log[0]} against exact {exact_loss0}")

    # the downstream head: ResNet-50, float32, B = FT_HEAD_BATCH, card against CPU
    head = RN25DWithMLPRef(RESNET)
    init_weights(head, torch.Generator().manual_seed(seed))
    x = torch.rand((FT_HEAD_BATCH, 128, 128, 3), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want = head.eval()(x)["kp3d"]
        got = head.to(dev)(x.to(dev))["kp3d"].cpu()
    head_err = rel_largest(got, want)
    require(head_err <= FT_HEAD_RTOL, f"RN25DWithMLPRef on the card: rel {head_err:.3e}")

    perf = {"steps": steps, "batch": FT_BATCH,
            "run_ms_per_step": run_ms, "step_ms": step_ms, "img_per_s": FT_BATCH / step_ms * 1e3,
            "composed_ms": turns["composed"], "held_ms": turns["held"],
            "feed_host_ms": host_ms, "image_stage_ms": stage_ms,
            "eval_s_in_run": window_evals, "evaluate_main_s": eval_main_s,
            "eval_img_per_s": FT_VAL / window_evals[-1], "saves": saves,
            "step0_det_total": exact_loss0,
            "fused_pallas_step0": pallas_log[0], "fused_pallas_rel": pallas_rel,
            "bn_backward_reduces_rel": sites_rel,
            "bn_backward_reduces_sites": sorted({m for m, _ in site_errs}),
            "launches": launches, "image_stage_card_vs_cpu": stage_mismatch,
            "head_rel_err": head_err, "metrics": ev[0]}
    print(f"fine-tune: {run_ms:.2f} ms/step over steps 2-{steps} (evaluation and saves "
          f"inside: {step_ms:.2f} ms/step without them, {FT_BATCH / step_ms * 1e3:.1f} img/s); "
          f"in turns composed {turns['composed']} / held {turns['held']} ms; feed host "
          f"{host_ms} ms, image stage {stage_ms} ms a batch; evaluations {window_evals} s "
          f"({FT_VAL / window_evals[-1]:.1f} img/s), evaluate main {eval_main_s:.2f} s; "
          f"head rel err {head_err:.2e}")
    return perf, launches


def _logging_step(step, log):
    def run(state, batch):
        state, parts = step(state, batch)
        log.append(float(parts["det_total"]))
        return state, parts

    return run


def ntxent_launches_a_step(name: str) -> int:
    """Launches of NT-Xent kernel ``name`` over the step's 2 * PAIRS rows:
    the kernel, and its splits' sum pass where its planner splits the
    columns."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K

    rows = 2 * PAIRS
    splits, _ = K._tensor_core_grid(rows, rows, torch.device("cuda"), K._TILE[name])
    return 1 + (splits > 1)


# per element of each BN kernel: the (M, C) planes it reads and writes, its
# float32 (C,) vectors (constants in, sums out), its float32 operations
BN_PLANES = {"masked_dual_reduce": 2, "masked_dx": 3,
             "masked_dual_reduce_res": 4, "masked_dx_res": 3}    # g x; g x dx; g x r dres; dres x dx
BN_VECTORS = {"masked_dual_reduce": 6, "masked_dx": 7,
              "masked_dual_reduce_res": 6, "masked_dx_res": 5}
BN_OPS = {"masked_dual_reduce": 8, "masked_dx": 11,
          "masked_dual_reduce_res": 9, "masked_dx_res": 6}
BN_PAIRS = {False: ("masked_dual_reduce", "masked_dx"),
            True: ("masked_dual_reduce_res", "masked_dx_res")}
# each BN kernel's profile group, (name, substrings of its kernels' names):
# #5 and #9 are bn_ring_reduce_kernel<T, MaskedTerms> and <T, CenteredTerms>,
# #6 and #8 bn_ring_dx_kernel<T, MaskedDy> and <T, StoredDy>;
# a reduce's sum pass is bn_sum_ctas_kernel<n>, one instance per reduce #n,
# which BN_SUM_PASS names; no kernel falls in two groups
BN_SUM_PASS = {"masked_dual_reduce": 5, "masked_dual_reduce_res": 7, "bn_backward_reduces": 9}
BN_PROFILE_GROUPS = {
    "masked_dual_reduce": ("bn_masked_reduce", ("MaskedTerms", "bn_sum_ctas_kernel<5>")),
    "masked_dx": ("bn_masked_dx", ("MaskedDy",)),
    "masked_dual_reduce_res": ("bn_res_reduce", ("bn_res_reduce_kernel",
                                                 "bn_sum_ctas_kernel<7>")),
    "masked_dx_res": ("bn_res_dx", ("StoredDy",)),
    "bn_backward_reduces": ("bn_dual_reduce", ("CenteredTerms", "bn_sum_ctas_kernel<9>")),
}
# the C entry points that run the bulk-copy ring: #5-#9
RING_KERNELS = ("masked_dual_reduce", "masked_dx", "masked_dual_reduce_res", "masked_dx_res",
                "dual_reduce")


class LaunchRecord:
    """Records every launch through bn_epilogue._launch (#5-#9) until
    remove(): the C entry point, C, and whether the CUDA source's own test
    (bn_ring_fits) sends it down the ring with these planes; fails where the
    Python mirror, ring_fits, answers otherwise. ``gradient_copies`` is for
    bn_site_bound's backward hooks to count in."""

    def __init__(self):
        from simhand_tpu_torch.models import bn_epilogue as E

        self.E, self.launch, self.seen, self.gradient_copies = E, E._launch, [], 0

        def launch(name, planes, consts, grid, outs):
            c, ptrs = planes[0].shape[1], [t.data_ptr() for t in (*planes, *outs)]
            fits = E.kernel_ring_fits(c, planes[0].dtype, *ptrs)
            require(fits == E.ring_fits(c, planes[0].element_size(), *ptrs),
                    f"{name} C={c}: ring_fits disagrees with the CUDA source's bn_ring_fits")
            self.seen.append((name, c, fits))
            return self.launch(name, planes, consts, grid, outs)

        E._launch = launch

    def remove(self) -> None:
        self.E._launch = self.launch

    def ring(self) -> list:
        """Whether each launch of a ring kernel took the ring, in order."""
        return [fits for name, _, fits in self.seen if name in RING_KERNELS]


def ring_taken(fn) -> bool:
    """Whether every ring-kernel launch of fn() took the ring."""
    rec = LaunchRecord()
    try:
        fn()
    finally:
        rec.remove()
    require(len(rec.ring()) > 0, "no ring kernel was launched")
    return all(rec.ring())


def sum_passes(sites) -> int:
    """Sum passes a reduce launches over sites of (M, C, element size):
    one wherever its persistent grid has more than one CTA."""
    from simhand_tpu_torch.models import bn_epilogue as E

    return sum(E._persistent_grid(m, c, es, "cuda")[1] > 1 for m, c, es in sites)


def site_times(name: str, sites, make, bound_fn, seed: int) -> dict:
    """One kernel timed alone (torch.profiler, device ms of the kernels of
    its profile group, sum pass included) at each distinct (M, C, element
    size) of a step's sites, on random (M, C) planes g and x (``make(g, x)``
    returns the call that launches it), with the L2 cache overwritten
    before each launch (a step's planes do not stay there), beside its
    bound: where its ms per step over its bound comes from."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    group = BN_PROFILE_GROUPS[name][1]
    rows, total, total_bound = [], 0.0, 0.0
    for (m, c, es), n in sorted(collections.Counter(sites).items()):
        dtype = torch.bfloat16 if es == 2 else torch.float32
        g, x = (torch.randn(m, c, device="cuda", generator=gen).to(dtype) for _ in range(2))
        call = make(g, x)

        def cold():
            flush.zero_()
            call()

        dev = sum(v for k, v in device_ms_by_kernel(cold, 10).items()
                  if any(p in k for p in group))
        b = bound_fn(m, c, es)[0]
        rows.append({"m": m, "c": c, "per_step": n, "device_ms": dev, "bound_ms": b})
        total, total_bound = total + n * dev, total_bound + n * b
        print(f"{name} site {m}x{c}: x{n} per step, device {dev:.4f} ms, bound {b:.4f} ms "
              f"({100 * b / dev:.1f}%), {n * (dev - b):.4f} ms/step over its bound")
        del g, x
    print(f"{name} alone at the step's sites (L2 flushed): {total:.4f} ms/step against its "
          f"bound {total_bound:.4f}")
    del flush
    torch.cuda.empty_cache()
    return {"sites": rows, "ms_per_step": total, "bound_ms_per_step": total_bound}


def bn_bound(name: str, m: int, c: int, esize: int) -> tuple[float, str]:
    """Least time of a BN kernel: bytes (each of its (M, C) planes read or
    written once, its float32 per-channel vectors once) over the memory
    rate, or its float32 operations over the float32 rate, the larger."""
    t_bytes = (BN_PLANES[name] * m * c * esize + 4 * BN_VECTORS[name] * c) / HBM_BYTES_PER_S
    t_ops = float(m) * c * BN_OPS[name] / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def exact_backward_ms(x, r, g, iters: int) -> tuple[float, float]:
    """The exact route's backward at a site: ReLU backward and the BatchNorm
    backward of F.batch_norm through autograd (the port's BatchNorm2d); ms
    by CUDA events over back-to-back calls (host enqueue included) and by
    torch.profiler (the device time of its kernels alone)."""
    import torch

    from simhand_tpu_torch.models.layers import BatchNorm2d

    bn = BatchNorm2d(x.shape[1]).cuda()
    xx = x.detach().requires_grad_()
    inputs = [xx, bn.weight, bn.bias]
    y = bn(xx)
    if r is not None:
        rr = r.detach().requires_grad_()
        inputs.append(rr)
        y = y + rr
    y = torch.relu(y)

    def backward():
        return torch.autograd.grad(y, inputs, g, retain_graph=True)

    return cuda_ms(backward, iters), device_ms(backward, iters)


def bn_kernel_phase(seed: int) -> dict:
    """Kernels #5-#8 against their plain versions, bf16 and float32, at the
    sites of BN_SHAPES: #5/#6 on g and x, #7 on g, x and r, #8 on the plain
    version's dres; a second launch of each gives the same bits."""
    import torch

    from simhand_tpu_torch.models import bn_epilogue as E

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {name: {} for name in BN_REPLACES}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for label, shape in BN_SHAPES:
            def plane():
                t = torch.randn(shape, device="cuda", generator=gen).to(dtype)
                return t.contiguous(memory_format=torch.channels_last)

            x, r, g = plane(), plane(), plane()
            c = shape[1]
            m = x.numel() // c
            scale = 1 + 0.5 * torch.randn(c, device="cuda", generator=gen)
            bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
            mu, _, inv = E.batch_stats(x, 1e-5)
            cs = list(E._affine_consts(mu, inv, scale, bias))
            P = scale * inv
            g2d, x2d, r2d = E.as_rows(g), E.as_rows(x), E.as_rows(r)
            k = [v / m for v in E.masked_dual_reduce_plain(g2d, x2d, *cs)]
            *sums_r, dres2d = E.masked_dual_reduce_res_plain(g2d, x2d, r2d, *cs)
            kr = [v / m for v in sums_r]
            dres = E.from_rows(dres2d, r)
            cases = {
                "masked_dual_reduce": (lambda: E.masked_dual_reduce(g, x, *cs),
                                       lambda: E.masked_dual_reduce_plain(g2d, x2d, *cs)),
                "masked_dx": (lambda: E.masked_dx(g, x, *cs, P, *k),
                              lambda: E.masked_dx_plain(g2d, x2d, *cs, P, *k)),
                "masked_dual_reduce_res": (
                    lambda: E.masked_dual_reduce_res(g, x, r, *cs),
                    lambda: E.masked_dual_reduce_res_plain(g2d, x2d, r2d, *cs)),
                "masked_dx_res": (
                    lambda: E.masked_dx_res(dres, x, *cs[2:], P, *kr),
                    lambda: E.masked_dx_res_plain(dres2d, x2d, *cs[2:], P, *kr)),
            }
            big = m * c >= 10**8
            for name, (kernel, plain) in cases.items():
                got, want, again = kernel(), plain(), kernel()
                torch.cuda.synchronize()
                got, want, again = ([t] if torch.is_tensor(t) else list(t)
                                    for t in (got, want, again))
                row = {"second_launch_bit_equal": all(torch.equal(a, b)
                                                      for a, b in zip(got, again))}
                require(row["second_launch_bit_equal"],
                        f"{name} {label} {tag}: a second launch gave other bits")
                if "reduce" in name:
                    rels = [rel_largest(a, b) for a, b in zip(got[:2], want[:2])]
                    row["sums_rel_err"] = max(rels)
                    require(max(rels) <= 1e-5, f"{name} {label} {tag}: sums rel err {rels}")
                if name == "masked_dual_reduce":
                    # a gradient that is not channels-last, which the wrapper copies
                    rels = [rel_largest(a, b)
                            for a, b in zip(E.masked_dual_reduce(g.contiguous(), x, *cs), want)]
                    row["sums_rel_err_nchw_g"] = max(rels)
                    require(max(rels) <= 1e-5, f"{name} {label} {tag} NCHW g: sums rel err {rels}")
                if name in RING_KERNELS:
                    row["ring"] = ring_taken(kernel)
                    require(row["ring"] == (label != "ragged"),
                            f"{name} {label} {tag}: ring taken {row['ring']}")
                # dres and dx: the same float32 operations, each rounded, in
                # the same order: bit for bit in both dtypes (a mask
                # difference would show here too)
                planes = [(E.as_rows(a), b) for a, b in zip(got, want) if a.dim() > 1]
                if planes:
                    row["not_bit_equal"] = sum(int((a != b).sum()) for a, b in planes)
                    if name == "masked_dual_reduce_res":
                        (a, b), = planes
                        row["mask_diffs"] = int(((a != 0) != (b != 0)).sum())
                        require(row["mask_diffs"] == 0, f"{name} {label} {tag}: mask differs")
                    require(row["not_bit_equal"] == 0,
                            f"{name} {label} {tag}: {row['not_bit_equal']} elements differ")
                row["max_abs_err"] = max(
                    float(((E.as_rows(a) if a.dim() > 1 else a).float() - b.float()).abs().max())
                    for a, b in zip(got, want))
                row["ms"] = cuda_ms(kernel, 20 if big else 50)
                if dtype == torch.bfloat16:
                    by_kernel = device_ms_by_kernel(kernel, 10)
                    row["device_ms"] = sum(by_kernel.values())
                    # the reduces' second pass, the fixed-order sum of partials
                    row["sum_device_ms"] = sum(v for k_, v in by_kernel.items() if "bn_sum_" in k_)
                row["plain_ms"] = cuda_ms(plain, 5)
                row["bound_ms"], row["bound_by"] = bn_bound(name, m, c, x.element_size())
                report[name][f"{label}_{tag}"] = row
                print(f"bn kernel {name} {label} {tag} ({m}x{c}): " + " ".join(
                    f"{k_}={v:.4g}" if isinstance(v, float) else f"{k_}={v}"
                    for k_, v in row.items()))
            if dtype == torch.bfloat16 and label != "ragged":
                res = label != "stem"
                pair = BN_PAIRS[res]
                exact, exact_device = exact_backward_ms(x, r if res else None, g, 20)
                rows = [report[n][f"{label}_{tag}"] for n in pair]
                pair_bound = sum(row["bound_ms"] for row in rows)
                for row in rows:
                    row.update(exact_pair_ms=exact, exact_pair_device_ms=exact_device,
                               pair_bound_ms=pair_bound)
                pair_device = sum(row["device_ms"] for row in rows)
                print(f"bn pair {pair[0]}+{pair[1]} {label} bf16: device {pair_device:.4f} ms "
                      f"(events {sum(row['ms'] for row in rows):.4f}), bound "
                      f"{pair_bound:.4f} ms ({100 * pair_bound / pair_device:.1f}%); exact "
                      f"route backward device {exact_device:.4f} ms, events {exact:.4f} ms")
            del cases, x, r, g, g2d, x2d, r2d, dres, dres2d
            torch.cuda.empty_cache()
    return report


def step0(state, batch, cfg):
    """Train-mode loss and parameter gradients of one forward and backward."""
    import torch

    from simhand_tpu_torch.models import contrastive_loss_from_projections

    model = state.model.train()
    images = torch.cat([batch["transformed_image1"], batch["transformed_image2"]])
    _, proj = model(images)
    loss, _ = contrastive_loss_from_projections(proj, batch, cfg)
    return float(loss.detach()), torch.autograd.grad(loss, state.params)


def bn_site_bound(model, cls=None) -> tuple[list, list, LaunchRecord]:
    """Forward hooks on the BNRelu sites (or those of ``cls``) that record
    each train-mode site's (M, C, element size, residual), backward hooks
    that count the gradients autograd hands them in another layout than
    channels-last (the wrapper copies those before the launch) into
    ``record.gradient_copies``, and a record of the BN kernels' launches;
    returns the list, the handles of all three (the record's last) and the
    record."""
    from simhand_tpu_torch.models.bn_epilogue import BNRelu

    cls = cls or BNRelu
    sites, handles, record = [], [], LaunchRecord()

    def hook(module, args, _out):
        x = args[0]
        if module.training:
            sites.append((x.numel() // x.shape[1], x.shape[1], x.element_size(),
                          len(args) > 1 and args[1] is not None))

    def backward_hook(module, grad_output):
        record.gradient_copies += not grad_output[0].movedim(1, -1).is_contiguous()

    for mod in model.modules():
        if isinstance(mod, cls):
            handles += [mod.register_forward_hook(hook),
                        mod.register_full_backward_pre_hook(backward_hook)]
    return sites, [*handles, record], record


def epilogue_path(seed: int, exact_state, batch, exact_loss0: float) -> tuple[dict, dict]:
    """The simhand_w step through the fused BN+ReLU encoder."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.train import make_eval_step, make_train_step

    cfg = step_config()
    states = {k: new_state(seed, bn_fused=k) for k in ("epilogue", "epilogue_xla")}
    (le, ge), (lx, gx), (_, ge2) = (step0(states[k], batch, cfg)
                                    for k in ("epilogue", "epilogue_xla", "epilogue"))
    names = [n for n, _ in states["epilogue"].model.named_parameters()]
    worst, worst_name, total = grad_diff(names, ge, gx)
    self_worst, self_name, self_total = grad_diff(names, ge2, ge)
    print(f"epilogue step 0: loss epilogue={le!r} epilogue_xla={lx!r} exact={exact_loss0!r}; "
          f"gradients vs epilogue_xla: worst {worst_name} {worst:.3e} of its norm, all "
          f"{total:.3e}; the epilogue against itself: worst {self_name} {self_worst:.3e}, "
          f"all {self_total:.3e}")
    require(le == lx, f"epilogue step-0 loss {le!r} != epilogue_xla's {lx!r}")
    require(abs(le - exact_loss0) <= LOSS_EXACT_RTOL * abs(exact_loss0),
            f"epilogue step-0 loss {le} differs from the exact route's {exact_loss0}")
    require(worst <= GRAD_TENSOR_RTOL and total <= GRAD_ALL_RTOL,
            "epilogue gradients differ from epilogue_xla's")
    del ge, gx, ge2

    states["exact"] = exact_state
    steps = {k: make_train_step(states[k].model, cfg) for k in ("exact", "epilogue", "epilogue_xla")}
    sites, handles, record = bn_site_bound(states["epilogue"].model)
    E.reset_launches()
    K.reset_launches()
    states["epilogue"], losses = run_steps(steps["epilogue"], states["epilogue"], batch,
                                           "epilogue", handles)
    ntx = {fn.__name__: fn.launches for fn in K.KERNELS}
    bn = {fn.__name__: fn.launches for fn in E.KERNELS}
    ring = record.ring()
    print(f"epilogue path losses {losses}; launches after {STEPS} steps {bn}, NT-Xent {ntx}; "
          f"step 0's {len(ring)} launches of #5-#8: {sum(ring)} on the ring; "
          f"{record.gradient_copies} gradients not channels-last")
    require(all(bn[n] == BN_PER_STEP[n] * STEPS for n in bn), f"BN kernel launches {bn}")
    require(len(ring) == sum(BN_PER_STEP[n] for n in RING_KERNELS if n in BN_PER_STEP)
            and all(ring), "a launch of #5-#8 in the epilogue step left the ring")
    require(ntx["weighted_ntxent_denominator"] == STEPS and ntx["weighted_grad_rows"] == STEPS,
            f"NT-Xent kernels #2/#4 did not launch on every epilogue step: {ntx}")
    kernel_bound = {n: sum(bn_bound(n, m, c, es)[0] for m, c, es, res in sites
                           if n in BN_PAIRS[res]) for n in BN_REPLACES}
    step_bound = sum(kernel_bound.values())
    print(f"epilogue sites per step: {len(sites)} ({sum(s[3] for s in sites)} with a "
          f"residual); bound of #5-#8 {step_bound:.4f} ms/step: " + ", ".join(
              f"{n} {v:.4f}" for n, v in kernel_bound.items()))

    mean_ms, blocks = in_turns(steps, states, batch, ("exact", "epilogue", "epilogue_xla",
                                                       "epilogue_xla", "epilogue", "exact"))
    eval_loss = float(make_eval_step(states["epilogue"].model, cfg)(states["epilogue"], batch)
                      ["contrastive_loss"])
    require(math.isfinite(eval_loss), "non-finite epilogue eval loss")
    launches = {fn.__name__: fn.launches for fn in E.KERNELS}
    n_train = STEPS + 2 * TIMED_STEPS
    require(all(launches[n] == BN_PER_STEP[n] * n_train for n in launches),
            f"BN kernel launches over the epilogue path {launches}")
    print("epilogue path timing (ms/step, in turns): " + ", ".join(
        f"{k} {v:.2f} = {PAIRS / v * 1e3:.1f} pairs/s" for k, v in mean_ms.items())
        + f"; eval {eval_loss}; blocks {blocks}")
    perf = {"step0_loss": le, "step0_grad_worst_rel": worst, "step0_grad_all_rel": total,
            "step0_self_worst_rel": self_worst, "step0_self_all_rel": self_total,
            "step_ms": mean_ms, "bn_bound_ms_per_step": step_bound, "step_ms_blocks": blocks,
            "bn_kernel_bound_ms_per_step": kernel_bound}
    perf.update(profile_steps(steps["epilogue"], states["epilogue"], batch))
    for n in BN_REPLACES:
        group = BN_PROFILE_GROUPS[n][0]
        ms, got = perf[f"profile_{group}_ms"], perf[f"profile_{group}_launches"]
        passes = sum_passes([s[:3] for s in sites if n in BN_PAIRS[s[3]]]) if n in BN_SUM_PASS \
            else 0
        sums = (f", sum passes {perf[f'profile_bn_sum_{BN_SUM_PASS[n]}_ms']:.4f}"
                if n in BN_SUM_PASS else "")
        print(f"epilogue step: {n} {ms:.4f} ms/step of device time ({got} launches/step{sums}) "
              f"against its bound {kernel_bound[n]:.4f} ms/step over the step's own sites")
        require(got == BN_PER_STEP[n] + passes,
                f"epilogue step: {got} launches/step of {n}'s group, not "
                f"{BN_PER_STEP[n]} + {passes} sum passes")

    def masked_reduce_at(g, x):
        mu, _, inv = E.batch_stats(x, 1e-5)
        ones = torch.ones(x.shape[1], device="cuda")
        cs = E._affine_consts(mu, inv, ones, 0.1 * ones)
        return lambda: E.masked_dual_reduce(g, x, *cs)

    def masked_dx_at(g, x):
        mu, _, inv = E.batch_stats(x, 1e-5)
        ones = torch.ones(x.shape[1], device="cuda")
        cs = E._affine_consts(mu, inv, ones, 0.1 * ones)
        k = [0.01 * ones, 0.02 * ones]
        return lambda: E.masked_dx(g, x, *cs, inv, *k)

    plain_sites = [s[:3] for s in sites if not s[3]]
    for name, make in (("masked_dual_reduce", masked_reduce_at), ("masked_dx", masked_dx_at)):
        perf[f"{name}_sites"] = site_times(name, plain_sites, make,
                                           functools.partial(bn_bound, name), seed)
    del states, steps
    return launches, perf


def fused_bn_bound(m: int, c: int, esize: int) -> tuple[float, str]:
    """Least time of kernel #9: bytes (x and dy read once, mu and inv read,
    the two sums written) over the memory rate, or its five float32
    operations per element (subtract, two multiplies, two adds) over the
    float32 rate, the larger."""
    t_bytes = (2 * m * c * esize + 4 * 4 * c) / HBM_BYTES_PER_S
    t_ops = 5.0 * m * c / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def fused_bn_kernel_phase(seed: int) -> dict:
    """Kernel #9 against its plain version and torch.batch_norm_backward_reduce,
    bf16 and float32, at the sites of BN_SHAPES."""
    import torch

    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.models import fused_bn as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for label, shape in BN_SHAPES:
            x, g = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                    .contiguous(memory_format=torch.channels_last) for _ in range(2))
            c = shape[1]
            m = x.numel() // c
            mu, _, inv = E.batch_stats(x, 1e-5)
            weight = torch.ones(c, device="cuda")
            x2d, g2d = E.as_rows(x), E.as_rows(g)

            def kernel():
                return F.bn_backward_reduces(x, g, mu, inv)

            def plain():
                return F.bn_backward_reduces_plain(x2d, g2d, mu, inv)

            def library():
                # grad_bias = sum dy, grad_weight = sum dy (x - mu) inv
                out = torch.batch_norm_backward_reduce(g, x, mu, inv, weight, False, True, True)
                return out[3], out[2]

            want = plain()
            row = {}
            for layout, dy in (("channels_last", g), ("nchw_dy", g.contiguous())):
                got, again = (F.bn_backward_reduces(x, dy, mu, inv) for _ in range(2))
                torch.cuda.synchronize()
                rels = [rel_largest(a, b) for a, b in zip(got, want)]
                require(max(rels) <= 1e-5, f"#9 {label} {tag} {layout}: sums rel err {rels}")
                require(all(torch.equal(a, b) for a, b in zip(got, again)),
                        f"#9 {label} {tag} {layout}: a second launch gave other bits")
                row[f"rel_err_{layout}"] = max(rels)
            row["second_launch_bit_equal"] = True
            row["ring"] = ring_taken(kernel)
            require(row["ring"] == (label != "ragged"), f"#9 {label} {tag}: ring {row['ring']}")
            row["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(kernel(), want))
            row["library_rel_diff"] = max(rel_largest(a, b) for a, b in zip(library(), want))
            big = m * c >= 10**8
            row["ms"] = cuda_ms(kernel, 20 if big else 50)
            row["device_ms"] = device_ms(kernel, 10)
            row["plain_ms"] = cuda_ms(plain, 5)
            row["library_ms"] = cuda_ms(library, 20 if big else 50)
            row["library_device_ms"] = device_ms(library, 10)
            row["bound_ms"], row["bound_by"] = fused_bn_bound(m, c, x.element_size())
            if dtype == torch.bfloat16 and label in ("stem", "layer1_bn3"):
                require(row["device_ms"] < row["library_device_ms"],
                        f"#9 {label} bf16: device {row['device_ms']:.4f} ms, not below "
                        f"torch.batch_norm_backward_reduce's {row['library_device_ms']:.4f}")
            report[f"{label}_{tag}"] = row
            print(f"fused-bn kernel bn_backward_reduces {label} {tag} ({m}x{c}): " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
            del x, g, x2d, g2d
            torch.cuda.empty_cache()
    return {"bn_backward_reduces": report}


def conv_bound(m: int, cin: int, cout: int, affine: bool) -> tuple[float, str]:
    """Least time of kernel #10 (#11 with affine): bytes (x, w read once, y
    and the two sums written; A and B read) over the memory rate, or the
    larger of the GEMM's 2*M*Cin*Cout operations over the bf16 tensor peak
    and the float32 operations (three per y element for the statistics,
    three per x element for the affine) over the float32 rate, the larger."""
    nbytes = 2 * (m * cin + cout * cin + m * cout) + 4 * 2 * cout + (4 * 2 * cin if affine else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    f32_ops = 3.0 * m * cout + (3.0 * m * cin if affine else 0)
    t_ops = max(2.0 * m * cin * cout / BF16_TENSOR_OPS_PER_S, f32_ops / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def conv_kernel_phase(seed: int) -> dict:
    """Kernels #10 and #11 against their plain versions at CONV_SHAPES."""
    import torch

    from simhand_tpu_torch.ops import conv1x1 as C

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {name: {} for name in CONV_REPLACES}
    for label, m, cin, cout, _ in CONV_SHAPES:
        x2d = torch.randn(m, cin, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(cout, cin, device="cuda", generator=gen) / math.sqrt(cin)).bfloat16()
        A = 1 + 0.3 * torch.randn(cin, device="cuda", generator=gen)
        B = 0.1 * torch.randn(cin, device="cuda", generator=gen)
        xa = torch.relu(x2d.float() * A + B).bfloat16()
        cases = {
            "conv1x1_stats": (lambda: C.conv1x1_stats(x2d, w),
                              lambda: C.conv1x1_stats_plain(x2d, w), x2d),
            "conv1x1_bn_relu_stats": (lambda: C.conv1x1_bn_relu_stats(x2d, w, A, B),
                                      lambda: C.conv1x1_bn_relu_stats_plain(x2d, w, A, B), xa),
        }
        for name, (kernel, plain, xin) in cases.items():
            (y, s1, s2), (py, ps1, ps2) = kernel(), plain()
            torch.cuda.synchronize()
            a, b = y.float(), py.float()
            _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
            ulp = torch.ldexp(torch.ones_like(a), e - 8)
            diff = (a - b).abs()
            floor = 2.0**-16 * (xin.float().abs() @ w.float().abs().T)
            row = {"max_abs_err": float(diff.max()),
                   "share_differ": float((diff > 0).float().mean()),
                   "share_over_one_ulp": float((diff > ulp).float().mean()),
                   "max_ulps": float((diff / ulp).max())}
            require(bool((diff <= ulp + floor).all()),
                    f"{name} {label}: y beyond one bf16 ulp of the plain version's {row}")
            y64 = y.double()
            own = [float((s.double() - t).abs().max() / t.abs().max())
                   for s, t in ((s1, y64.sum(0)), (s2, (y64 * y64).sum(0)))]
            vs_plain = [float((s - t).abs().max() / t.abs().max()) for s, t in ((s1, ps1), (s2, ps2))]
            row["stats_rel_err_own_y"], row["stats_rel_err_plain"] = max(own), max(vs_plain)
            require(max(own) <= 1e-5, f"{name} {label}: s1/s2 vs its own y {own}")
            require(max(vs_plain) <= 1e-3, f"{name} {label}: s1/s2 vs the plain version {vs_plain}")
            again = kernel()
            torch.cuda.synchronize()
            require(all(torch.equal(u, v) for u, v in zip(again, (y, s1, s2))),
                    f"{name} {label}: a second launch gave other bits")
            del y, s1, s2, py, ps1, ps2, a, b, e, ulp, diff, floor, y64, again
            iters = 50 if m <= 32768 else 20
            row["ms"] = cuda_ms(kernel, iters)
            by_kernel = device_ms_by_kernel(kernel, 10)
            row["device_ms"] = sum(by_kernel.values())
            row["kernel_device_ms"] = sum(v for k, v in by_kernel.items()
                                          if "conv1x1_stats_kernel" in k)
            row["sum_device_ms"] = sum(v for k, v in by_kernel.items()
                                       if "conv1x1_sum_partials" in k)
            row["plain_ms"] = cuda_ms(plain, 5)
            row["matmul_ms"] = cuda_ms(lambda: x2d @ w.T, iters)
            row["matmul_device_ms"] = device_ms(lambda: x2d @ w.T, 10)
            row["ratio_to_matmul"] = row["device_ms"] / row["matmul_ms"]
            row["bound_ms"], row["bound_by"] = conv_bound(m, cin, cout,
                                                          name == "conv1x1_bn_relu_stats")
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            report[name][label] = row
            print(f"conv kernel {name} {label} ({m}x{cin}->{cout}): " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
        del cases, x2d, w, xa
        torch.cuda.empty_cache()
    return report


def grad_diff(names, got, want):
    """The worst parameter gradient's difference relative to its norm (with
    its name), and all of them together relative to their norm."""
    errs = [float((a - b).double().norm() / b.double().norm()) for a, b in zip(got, want)]
    total = (sum(float((a - b).double().norm()) ** 2 for a, b in zip(got, want))
             / sum(float(b.double().norm()) ** 2 for b in want)) ** 0.5
    worst = max(range(len(errs)), key=errs.__getitem__)
    return errs[worst], names[worst], total


def fused_bn_path(seed: int, exact_state, batch, exact_loss0: float) -> tuple[dict, dict]:
    """The simhand_w step with bn_fused="pallas" (kernel #9) and True."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.models import fused_bn as F
    from simhand_tpu_torch.train import make_eval_step, make_train_step

    cfg = step_config()
    states = {"pallas": new_state(seed, bn_fused="pallas"),
              "fused_plain": new_state(seed, bn_fused=True)}
    (lp, gp), (lt, gt), (_, gp2) = (step0(states[k], batch, cfg)
                                    for k in ("pallas", "fused_plain", "pallas"))
    names = [n for n, _ in states["pallas"].model.named_parameters()]
    worst, worst_name, total = grad_diff(names, gp, gt)
    self_worst, self_name, self_total = grad_diff(names, gp2, gp)
    print(f"fused-bn step 0: loss pallas={lp!r} bn_fused=True {lt!r} exact={exact_loss0!r} "
          f"(rel {abs(lp - exact_loss0) / abs(exact_loss0):.3e}); gradients vs bn_fused=True: "
          f"worst {worst_name} {worst:.3e} of its norm, all {total:.3e}; pallas against "
          f"itself: worst {self_name} {self_worst:.3e}, all {self_total:.3e}")
    require(lp == lt, f"pallas step-0 loss {lp!r} != bn_fused=True's {lt!r}")
    require(abs(lp - exact_loss0) <= LOSS_TWO_ROUNDING_RTOL * abs(exact_loss0),
            f"pallas step-0 loss {lp} differs from the exact route's {exact_loss0}")
    require(worst <= GRAD_TENSOR_RTOL and total <= GRAD_ALL_RTOL,
            "pallas gradients differ from bn_fused=True's")
    del gp, gt, gp2

    states["exact"] = exact_state
    steps = {k: make_train_step(states[k].model, cfg) for k in ("exact", "pallas", "fused_plain")}
    sites, handles, record = bn_site_bound(states["pallas"].model, F.FusedBatchNorm)
    F.reset_launches()
    K.reset_launches()
    states["pallas"], losses = run_steps(steps["pallas"], states["pallas"], batch, "pallas",
                                         handles)
    launches, ntx = F.bn_backward_reduces.launches, {fn.__name__: fn.launches for fn in K.KERNELS}
    ring = record.ring()
    print(f"fused-bn path losses {losses}; #9 launches after {STEPS} steps {launches}, "
          f"NT-Xent {ntx}; step 0's {len(ring)} launches of #9: {sum(ring)} on the ring; "
          f"{record.gradient_copies} gradients not channels-last")
    require(len(sites) == FUSED_BN_PER_STEP, f"{len(sites)} FusedBatchNorm sites per step")
    require(len(ring) == FUSED_BN_PER_STEP and all(ring),
            "a launch of #9 in the pallas step left the ring")
    require(launches == FUSED_BN_PER_STEP * STEPS, f"#9 launches {launches}")
    require(ntx["weighted_ntxent_denominator"] == STEPS and ntx["weighted_grad_rows"] == STEPS,
            f"NT-Xent kernels #2/#4 did not launch on every pallas step: {ntx}")
    step_bound = sum(fused_bn_bound(m, c, es)[0] for m, c, es, _ in sites)
    print(f"fused-bn sites per step: {len(sites)}; byte bound of #9 {step_bound:.4f} ms/step")

    mean_ms, blocks = in_turns(steps, states, batch, ("exact", "pallas", "fused_plain",
                                                       "fused_plain", "pallas", "exact"))
    eval_loss = float(make_eval_step(states["pallas"].model, cfg)(states["pallas"], batch)
                      ["contrastive_loss"])
    require(math.isfinite(eval_loss), "non-finite pallas eval loss")
    n_train = STEPS + 2 * TIMED_STEPS
    launches = F.bn_backward_reduces.launches
    require(launches == FUSED_BN_PER_STEP * n_train, f"#9 launches over the path {launches}")
    print("fused-bn path timing (ms/step, in turns): " + ", ".join(
        f"{k} {v:.2f} = {PAIRS / v * 1e3:.1f} pairs/s" for k, v in mean_ms.items())
        + f"; eval {eval_loss}; blocks {blocks}")
    perf = {"step0_loss": lp, "step0_loss_rel_exact": abs(lp - exact_loss0) / abs(exact_loss0),
            "step0_grad_worst_rel": worst, "step0_grad_all_rel": total,
            "step0_self_worst_rel": self_worst, "step0_self_all_rel": self_total,
            "step_ms": mean_ms, "bound_ms_per_step": step_bound, "step_ms_blocks": blocks}
    perf.update(profile_steps(steps["pallas"], states["pallas"], batch))
    ms, got = perf["profile_bn_dual_reduce_ms"], perf["profile_bn_dual_reduce_launches"]
    passes = sum_passes([s[:3] for s in sites])
    print(f"pallas step: bn_backward_reduces {ms:.4f} ms/step of device time ({got} "
          f"launches/step, sum passes {perf['profile_bn_sum_9_ms']:.4f}) against its bound "
          f"{step_bound:.4f} ms/step over the step's own sites")
    require(got == FUSED_BN_PER_STEP + passes,
            f"pallas step: {got} launches/step of #9's group, not {FUSED_BN_PER_STEP} + "
            f"{passes} sum passes")

    def dual_reduce_at(g, x):
        mu, _, inv = E.batch_stats(x, 1e-5)
        return lambda: F.bn_backward_reduces(x, g, mu, inv)

    perf["bn_backward_reduces_sites"] = site_times(
        "bn_backward_reduces", [s[:3] for s in sites], dual_reduce_at, fused_bn_bound, seed)
    del states, steps
    return {"bn_backward_reduces": launches}, perf


def conv_site_hooks(model, threshold: int) -> tuple[list, list]:
    """Hooks that record each train-mode fused conv1x1+BN site's (M, Cin,
    Cout): a bottleneck's input is conv1's, its bn2's output conv3's."""
    from simhand_tpu_torch.models.resnet import Bottleneck

    sites, handles = [], []

    def record(module, x, cout):
        if module.training and x.shape[1] >= threshold:
            sites.append((x.numel() // x.shape[1], x.shape[1], cout))

    for block in model.modules():
        if isinstance(block, Bottleneck):
            handles.append(block.register_forward_pre_hook(
                lambda mod, args: record(mod, args[0], mod.conv1.out_channels)))
            handles.append(block.bn2.register_forward_hook(
                lambda mod, args, out, b=block: record(mod, out, b.conv3.out_channels)))
    return sites, handles


# the fused site against cuDNN's conv + BatchNorm at sites of the step
# (N, Cin, H, W, Cout): each of o, dx, dw, dscale, dbias within 1e-2 of its
# norm (bf16 values one ulp apart, 2^-8, in a fraction of the elements)
SITE_SHAPES = (("layer2_conv1", (512, 512, 16, 16), 128),
               ("layer3_conv1", (512, 1024, 8, 8), 256),
               ("layer4_conv3", (512, 512, 4, 4), 2048))
SITE_RTOL = 1e-2


def site_check(seed: int) -> dict:
    """The fused conv1x1+BN site's output and gradients against the exact
    site (the port's Conv2d and BatchNorm2d: cuDNN's convolution and
    PyTorch's batch norm) on the same inputs, bf16, train mode."""
    import torch

    from simhand_tpu_torch.models.fused_conv import fused_conv_bn_site
    from simhand_tpu_torch.models.layers import BatchNorm2d, Conv2d

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for label, shape, cout in SITE_SHAPES:
        conv = Conv2d(shape[1], cout, 1, dtype=torch.bfloat16).cuda()
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, device="cuda", generator=gen)
                              / math.sqrt(shape[1]))
        bn = BatchNorm2d(cout).cuda()
        with torch.no_grad():
            bn.weight.copy_(1 + 0.3 * torch.randn(cout, device="cuda", generator=gen))
            bn.bias.copy_(0.1 * torch.randn(cout, device="cuda", generator=gen))
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16().contiguous(
            memory_format=torch.channels_last)
        g = torch.randn((shape[0], cout, *shape[2:]), device="cuda", generator=gen).bfloat16()
        g = g.contiguous(memory_format=torch.channels_last)
        outs = []
        for fused in (True, False):
            xx = x.clone().requires_grad_()
            o = fused_conv_bn_site(conv, bn, xx) if fused else bn(conv(xx))
            grads = torch.autograd.grad(o, (xx, conv.weight, bn.weight, bn.bias), g)
            outs.append([o.detach(), *grads])
        row = {name: float((a.double() - b.double()).norm() / b.double().norm())
               for name, a, b in zip(("o", "dx", "dw", "dscale", "dbias"), *outs)}
        report[label] = row
        print(f"conv1x1 site {label} {shape} -> {cout}, fused vs exact (rel to norm): "
              + " ".join(f"{k}={v:.3e}" for k, v in row.items()))
        require(max(row.values()) <= SITE_RTOL, f"fused site {label} differs from the exact one")
        del conv, bn, x, g, outs
        torch.cuda.empty_cache()
    return report


def conv1x1_path(seed: int, exact_state, batch) -> tuple[dict, dict]:
    """The simhand_w step with conv1x1_fuse_min_cin=512 (kernel #10)."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.ops import conv1x1 as C
    from simhand_tpu_torch.train import make_train_step

    cfg = step_config()
    states = {"conv1x1": new_state(seed, conv1x1_fuse_min_cin=CONV_FUSE_MIN_CIN),
              "exact0": new_state(seed)}
    (lc, gc), (le, ge), (_, ge2) = (step0(states[k], batch, cfg)
                                    for k in ("conv1x1", "exact0", "exact0"))
    names = [n for n, _ in states["conv1x1"].model.named_parameters()]
    worst, worst_name, total = grad_diff(names, gc, ge)
    self_worst, self_name, self_total = grad_diff(names, ge2, ge)
    rel = abs(lc - le) / abs(le)
    print(f"conv1x1 step 0: loss conv1x1={lc!r} exact={le!r} (rel {rel:.3e}); gradients vs "
          f"exact: worst {worst_name} {worst:.3e} of its norm, all {total:.3e}; exact against "
          f"itself: worst {self_name} {self_worst:.3e}, all {self_total:.3e}")
    require(rel <= LOSS_EXACT_RTOL, f"conv1x1 step-0 loss {lc} differs from the exact route's {le}")
    # The step's gradients are not held to GRAD_*_RTOL here: those limits
    # compare two routes with the same forward (epilogue and epilogue_xla,
    # pallas and bn_fused=True). This forward rounds differently from the
    # exact one, and the bf16 step's parameter gradients are dominated by
    # rounding at init: on the CPU (scripts/torch_bf16_departure.py) exact
    # bf16 departs from exact float32 by 1.34 of the gradients' norm, the
    # epilogue from exact by 1.38, this route from exact by 0.69 (0.71 on
    # an H100). site_check holds the site's own gradients instead.
    del gc, ge, ge2, states["exact0"]
    sites_vs_exact = site_check(seed)

    states["exact"] = exact_state
    steps = {k: make_train_step(states[k].model, cfg) for k in ("exact", "conv1x1")}
    sites, handles = conv_site_hooks(states["conv1x1"].model, CONV_FUSE_MIN_CIN)
    C.reset_launches()
    K.reset_launches()
    states["conv1x1"], losses = run_steps(steps["conv1x1"], states["conv1x1"], batch, "conv1x1",
                                          handles)
    launches = {fn.__name__: fn.launches for fn in C.KERNELS}
    ntx = {fn.__name__: fn.launches for fn in K.KERNELS}
    print(f"conv1x1 path losses {losses}; launches after {STEPS} steps {launches}, NT-Xent {ntx}; "
          f"sites {sorted(set(sites))}")
    require(len(sites) == CONV_PER_STEP, f"{len(sites)} fused conv1x1 sites per step")
    require(launches == {"conv1x1_stats": CONV_PER_STEP * STEPS, "conv1x1_bn_relu_stats": 0},
            f"conv1x1 kernel launches {launches}")
    require(ntx["weighted_ntxent_denominator"] == STEPS and ntx["weighted_grad_rows"] == STEPS,
            f"NT-Xent kernels #2/#4 did not launch on every conv1x1 step: {ntx}")
    step_bound = sum(conv_bound(m, cin, cout, False)[0] for m, cin, cout in sites)
    print(f"conv1x1 sites per step: {len(sites)}; bound of #10 {step_bound:.4f} ms/step")

    mean_ms, blocks = in_turns(steps, states, batch, ("exact", "conv1x1", "conv1x1", "exact"))
    launches = {fn.__name__: fn.launches for fn in C.KERNELS}
    n_train = STEPS + 2 * TIMED_STEPS
    require(launches["conv1x1_stats"] == CONV_PER_STEP * n_train,
            f"#10 launches over the path {launches}")
    print("conv1x1 path timing (ms/step, in turns): " + ", ".join(
        f"{k} {v:.2f} = {PAIRS / v * 1e3:.1f} pairs/s" for k, v in mean_ms.items())
        + f"; blocks {blocks}")
    perf = {"step0_loss": lc, "step0_loss_rel_exact": rel, "step0_grad_worst_rel": worst,
            "step0_grad_all_rel": total, "exact_self_worst_rel": self_worst,
            "exact_self_all_rel": self_total, "site_vs_exact": sites_vs_exact, "step_ms": mean_ms,
            "bound_ms_per_step": step_bound, "step_ms_blocks": blocks}
    perf.update(profile_steps(steps["conv1x1"], states["conv1x1"], batch))
    del states, steps
    return launches, perf


def conv_f32_bound(m: int, cin: int, cout: int, affine: bool) -> tuple[float, str]:
    """Least time of float32 #10 (#11 with affine): bytes (x, w read once, y
    and the sums written; A and B read) over the memory rate, or the GEMM's
    2*M*Cin*Cout operations and the statistics' (and the affine's) three a
    y (x) element over the float32 rate, the larger."""
    nbytes = 4 * (m * cin + cout * cin + m * cout + 2 * cout + (2 * cin if affine else 0))
    ops = 2.0 * m * cin * cout + 3.0 * m * cout + (3.0 * m * cin if affine else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def conv_f32_phase(seed: int) -> dict:
    """Float32 kernels #10 and #11 against their plain versions at the six
    fused-site shapes of CONV_SHAPES, beside cuBLAS's float32 x @ w.T."""
    import torch

    from simhand_tpu_torch.ops import conv1x1 as C

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {f"{name}_f32": {} for name in CONV_REPLACES}
    for label, m, cin, cout, per_step in CONV_SHAPES:
        if per_step == 0:
            continue
        x2d = torch.randn(m, cin, device="cuda", generator=gen)
        w = torch.randn(cout, cin, device="cuda", generator=gen) / math.sqrt(cin)
        A = 1 + 0.3 * torch.randn(cin, device="cuda", generator=gen)
        B = 0.1 * torch.randn(cin, device="cuda", generator=gen)
        cases = {
            "conv1x1_stats_f32": (lambda: C.conv1x1_stats(x2d, w),
                                  lambda: C.conv1x1_stats_plain(x2d, w)),
            "conv1x1_bn_relu_stats_f32": (lambda: C.conv1x1_bn_relu_stats(x2d, w, A, B),
                                          lambda: C.conv1x1_bn_relu_stats_plain(x2d, w, A, B)),
        }
        for name, (kernel, plain) in cases.items():
            (y, s1, s2), (py, ps1, ps2) = kernel(), plain()
            torch.cuda.synchronize()
            require(y.dtype == torch.float32, f"{name} {label}: y is {y.dtype}")
            err = float((y - py).abs().max())
            row = {"max_abs_err": err, "y_rel_err": err / float(py.abs().max())}
            require(row["y_rel_err"] <= F32_Y_RTOL, f"{name} {label}: y differs {row}")
            y64 = y.double()
            own = [float((u.double() - t).abs().max() / t.abs().max())
                   for u, t in ((s1, y64.sum(0)), (s2, (y64 * y64).sum(0)))]
            vs_plain = [float((u - t).abs().max() / t.abs().max())
                        for u, t in ((s1, ps1), (s2, ps2))]
            row["stats_rel_err_own_y"], row["stats_rel_err_plain"] = max(own), max(vs_plain)
            require(max(own) <= 1e-5, f"{name} {label}: s1/s2 vs its own y {own}")
            again = kernel()
            torch.cuda.synchronize()
            require(all(torch.equal(u, v) for u, v in zip(again, (y, s1, s2))),
                    f"{name} {label}: a second launch gave other bits")
            del y, s1, s2, py, ps1, ps2, y64, again
            row["ms"] = cuda_ms(kernel, 10)
            by_kernel = device_ms_by_kernel(kernel, 5)
            row["device_ms"] = sum(by_kernel.values())
            row["sum_device_ms"] = sum(v for k, v in by_kernel.items()
                                       if "conv1x1_sum_partials" in k)
            row["plain_ms"] = cuda_ms(plain, 5)
            row["matmul_ms"] = cuda_ms(lambda: x2d @ w.T, 10)
            row["matmul_device_ms"] = device_ms(lambda: x2d @ w.T, 5)
            row["ratio_to_matmul"] = row["device_ms"] / row["matmul_device_ms"]
            row["bound_ms"], row["bound_by"] = conv_f32_bound(m, cin, cout, "bn_relu" in name)
            row["bound_share"] = row["bound_ms"] / row["device_ms"]
            report[name][label] = row
            print(f"conv kernel {name} {label} ({m}x{cin}->{cout}): " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
        del cases, x2d, w
        torch.cuda.empty_cache()
    return report


def conv1x1_f32_path(seed: int, batch) -> tuple[dict, dict]:
    """F32_STEPS float32 steps with conv1x1_fuse_min_cin=512 (float32 #10):
    the step-0 loss against the float32 exact step's."""
    import torch

    from simhand_tpu_torch.ops import conv1x1 as C
    from simhand_tpu_torch.train import make_train_step

    cfg = step_config()
    exact = new_state(seed, dtype=torch.float32)
    le = step0(exact, batch, cfg)[0]
    del exact
    state = new_state(seed, dtype=torch.float32, conv1x1_fuse_min_cin=CONV_FUSE_MIN_CIN)
    lc = step0(state, batch, cfg)[0]
    rel = abs(lc - le) / abs(le)
    step = make_train_step(state.model, cfg)
    C.reset_launches()
    state, losses = run_steps(step, state, batch, "float32 conv1x1", steps=F32_STEPS)
    launches = {f"{fn.__name__}_f32": fn.launches for fn in C.KERNELS}
    state, _, dt = timed(step, state, batch, F32_STEPS)
    print(f"float32 conv1x1 path: step-0 loss {lc!r}, float32 exact {le!r} (rel {rel:.3e}); "
          f"losses {losses}; launches after {F32_STEPS} steps {launches}; "
          f"{dt * 1e3:.2f} ms/step")
    require(rel <= F32_LOSS_RTOL, f"float32 conv1x1 step-0 loss {lc} differs from the float32 "
            f"exact step's {le}")
    require(launches == {"conv1x1_stats_f32": CONV_PER_STEP * F32_STEPS,
                         "conv1x1_bn_relu_stats_f32": 0}, f"float32 #10 launches {launches}")
    del state, step
    torch.cuda.empty_cache()
    return launches, {"step0_loss": lc, "exact_step0_loss": le, "step0_loss_rel_exact": rel,
                      "losses": losses, "step_ms": dt * 1e3}


def read_pixels(size: int, out: int, k: int, stride: int, lo: int) -> int:
    """How many of a spatial dimension's `size` positions a convolution's
    windows read (a 1x1/2 reads every other one)."""
    return len({stride * o + t - lo for o in range(out) for t in range(k)} & set(range(size)))


def conv_bias_bound(x_elems: int, m: int, cout: int, k: int, res: bool) -> tuple[float, str]:
    """Least time of the convolution kernel: bytes (the input pixels its
    windows read, the weight, the bias and the residual read once, y written
    once) over the memory rate, or the larger of the 2*M*Cout*K products
    over the bf16 tensor peak and the float32 epilogue (bias, residual,
    ReLU: 2 + res operations per output) over the float32 rate, the
    larger."""
    nbytes = 2 * x_elems + 2 * cout * k + 4 * cout + 2 * m * cout * (2 if res else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(2.0 * m * cout * k / BF16_TENSOR_OPS_PER_S,
                (2.0 + res) * m * cout / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def conv_bias_phase(seed: int) -> dict:
    """The convolution kernel against its plain version at CONV_BIAS_SHAPES,
    beside bf16 cuDNN F.conv2d with the bias."""
    import torch
    import torch.nn.functional as F

    from simhand_tpu_torch.ops import conv_bias as CB

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for label, n, h, w, cin, cout, k, stride, padding, relu, with_res in CONV_BIAS_SHAPES:
        x = torch.randn(n, h, w, cin, device="cuda", generator=gen).bfloat16()
        wt = (torch.randn(cout, k * k * cin, device="cuda", generator=gen)
              / math.sqrt(k * k * cin)).bfloat16()
        b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        pads = CB.conv_pads(h, w, (k, k), stride, padding)
        oh, ow = CB.out_size(h, w, (k, k), stride, pads)
        res = (torch.randn(n, oh, ow, cout, device="cuda", generator=gen).bfloat16()
               if with_res else None)
        kw = dict(kernel=(k, k), stride=stride, padding=padding, relu=relu, res=res)
        # the yardstick: one cuDNN call, the NCHW views of the same memory
        xn = x.permute(0, 3, 1, 2)
        w4 = wt.view(cout, k, k, cin).permute(0, 3, 1, 2)
        b16 = b.bfloat16()
        lib_pad = (max(pads[0]), max(pads[1]))

        def kernel():
            return CB.conv_bias_act(x, wt, b, **kw)

        def plain():
            return CB.conv_bias_act_plain(x, wt, b, **kw)

        def library():
            return F.conv2d(xn, w4, b16, stride=stride, padding=lib_pad)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        a, c = got.float(), want.float()
        _, e = torch.frexp(torch.maximum(a.abs(), c.abs()))
        ulp = torch.ldexp(torch.ones_like(a), e - 8)
        diff = (a - c).abs()
        floor = (2.0**-16 * (CB.patches(x.float().abs(), (k, k), stride, pads)
                             @ wt.float().abs().T)).view(a.shape)
        row = {"max_abs_err": float(diff.max()),
               "share_differ": float((diff > 0).float().mean()),
               "share_over_one_ulp": float((diff > ulp).float().mean())}
        require(bool((diff <= ulp + floor).all()),
                f"conv_bias_act {label}: y beyond one bf16 ulp of the plain version's {row}")
        again = kernel()
        torch.cuda.synchronize()
        require(torch.equal(again, got), f"conv_bias_act {label}: a second launch gave other bits")
        del got, want, a, c, e, ulp, diff, floor, again
        big = n * oh * ow * cout >= 2**24
        row["ms"] = cuda_ms(kernel, 20 if big else 50)
        by_kernel = device_ms_by_kernel(kernel, 10)
        row["device_ms"] = sum(by_kernel.values())
        row["kernel_device_ms"] = sum(v for key, v in by_kernel.items()
                                      if "conv_bias_kernel" in key)
        row["plain_ms"] = cuda_ms(plain, 3)
        row["library_ms"] = cuda_ms(library, 20 if big else 50)
        row["library_device_ms"] = device_ms(library, 10)
        row["ratio_to_library"] = row["device_ms"] / row["library_device_ms"]
        x_read = (n * cin * read_pixels(h, oh, k, stride, pads[0][0])
                  * read_pixels(w, ow, k, stride, pads[1][0]))
        row["bound_ms"], row["bound_by"] = conv_bias_bound(x_read, n * oh * ow, cout,
                                                           k * k * cin, with_res)
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        report[label] = row
        print(f"conv_bias_act {label} ({n}x{h}x{w}x{cin} -> {cout}, {k}x{k}/{stride}, res "
              f"{with_res}): " + " ".join(f"{key}={v:.4g}" if isinstance(v, float) else
                                          f"{key}={v}" for key, v in row.items()))
        del x, wt, b, res, xn, w4, b16
        torch.cuda.empty_cache()
    return {"conv_bias_act": report}


def block_bound(m: int, cin: int, cm: int) -> tuple[float, str]:
    """Least time of kernel #12: bytes (x read once, y written once, the bf16
    weights and float32 biases read once) over the memory rate, or the three
    GEMMs' 2*M*(Cin*Cm + 9*Cm^2 + Cm*Cin) operations over the bf16 tensor
    peak, the larger."""
    weights = cin * cm + 9 * cm * cm + cm * cin
    t_bytes = (2 * 2 * m * cin + 2 * weights + 4 * (2 * cm + cin)) / HBM_BYTES_PER_S
    t_ops = 2.0 * m * weights / BF16_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def block_args(gen, imgs: int, hw, cin: int, cm: int):
    """x and the K-contiguous folded weights of one identity block, with the
    scales of a folded ResNet block (weights ~ 1/sqrt(fan-in))."""
    import torch

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    x = randn(imgs * hw[0] * hw[1], cin).bfloat16()
    w1 = randn(cm, cin, scale=cin**-0.5).bfloat16()
    w2 = randn(cm, 9, cm, scale=(9 * cm) ** -0.5).bfloat16()
    w3 = randn(cin, cm, scale=cm**-0.5).bfloat16()
    return x, w1, 0.1 * randn(cm), w2, 0.1 * randn(cm), w3, 0.1 * randn(cin)


def cudnn_ops(fw: dict):
    """The folded walk's ops through cuDNN, the yardstick the port does not
    use: bf16 cuDNN convolutions (their float32 sums rounded to bf16), the
    float32 bias added in one pass and rounded again, ReLU on the bf16
    result, the shortcut's add in bf16."""
    import torch

    from simhand_tpu_torch.serving.int8_infer import _conv, _maxpool

    weights = {key: (w.to(torch.bfloat16), b.float()) for key, (w, b) in fw.items()}

    class CudnnBf16Ops:
        def input(self, key, x):
            return x.to(torch.bfloat16)

        def conv_bn(self, key, x, stride, padding):
            w, b = weights[key]
            y = _conv(x, w, stride, padding)
            return torch.add(y, b.view(1, -1, 1, 1), out=torch.empty_like(y))

        def conv_bn_relu(self, key, x, stride, padding):
            return torch.relu_(self.conv_bn(key, x, stride, padding))

        def add_relu(self, key, y, shortcut):
            return torch.relu_(y + shortcut)

        def maxpool(self, x):
            return _maxpool(x)

        def to_f32(self, x):
            return x.float()

    return CudnnBf16Ops()


def cudnn_walk(model):
    """The frozen bf16 folded forward through ``cudnn_ops``: images (N, H, W,
    3) -> (N, C) float32."""
    import torch

    from simhand_tpu_torch.serving import int8_infer

    ops = cudnn_ops(int8_infer._fold_resnet(model.encoder, model.resnet_size))

    def forward(images):
        with torch.no_grad():
            return int8_infer._walk_resnet(ops, model.resnet_size, images, pool=True)

    return forward


def cudnn_block(imgs: int, hw, args):
    """The same block through ``cudnn_ops`` (three bf16 cuDNN convolutions,
    the float32 biases, ReLUs and the shortcut's add): a zero-argument
    callable returning the (M, C) plane."""
    x, w1, b1, w2, b2, w3, b3 = args
    (h, w), cm, c = hw, w1.shape[0], x.shape[1]
    ops = cudnn_ops({"b/conv1": (w1.view(cm, c, 1, 1), b1),
                     "b/conv2": (w2.view(cm, 3, 3, cm).permute(0, 3, 1, 2).contiguous(), b2),
                     "b/conv3": (w3.view(c, cm, 1, 1), b3)})
    xi = x.view(imgs, h, w, c).permute(0, 3, 1, 2)

    def run():
        y = ops.conv_bn_relu("b/conv1", xi, 1, "SAME")
        y = ops.conv_bn_relu("b/conv2", y, 1, "SAME")
        y = ops.add_relu("b/out", ops.conv_bn("b/conv3", y, 1, "SAME"), xi)
        return y.permute(0, 2, 3, 1).reshape(-1, c)

    return run


def ulp_share(got, want) -> float:
    """Share of elements more than one bf16 ulp apart at the larger magnitude."""
    import torch

    a, b = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() > torch.ldexp(torch.ones_like(a), e - 8)).float().mean())


def block_kernel_phase(seed: int) -> dict:
    """Kernel #12 (three launches of the convolution kernel) against its
    plain version at BLOCK_SHAPES, beside the block through cuDNN."""
    import torch

    from simhand_tpu_torch.ops import bottleneck_block as BB

    gen = torch.Generator(device="cuda").manual_seed(seed)
    report = {}
    for label, imgs, hw, cin, cm in BLOCK_SHAPES:
        args = block_args(gen, imgs, hw, cin, cm)
        m = args[0].shape[0]

        def kernel():
            return BB.bottleneck_block(*args, hw=hw)

        def plain():
            return BB.bottleneck_block_plain(*args, hw=hw)

        cudnn = cudnn_block(imgs, hw, args)
        got, want, walk = kernel(), plain(), cudnn()
        torch.cuda.synchronize()
        row = {"max_abs_err": float((got.float() - want.float()).abs().max()),
               "share_over_one_ulp": ulp_share(got, want),
               "cudnn_max_abs_diff": float((walk.float() - want.float()).abs().max())}
        close = bool(((got.float() - want.float()).abs()
                      <= BLOCK_RTOL + BLOCK_RTOL * want.float().abs()).all())
        require(close and row["share_over_one_ulp"] <= BLOCK_ULP_SHARE,
                f"#12 {label}: y differs from the plain version's {row}")
        del got, want, walk
        big = m * cin >= 2**24
        row["ms"] = cuda_ms(kernel, 20 if big else 50)
        row["device_ms"] = device_ms(kernel, 10)
        row["plain_ms"] = cuda_ms(plain, 3)
        row["cudnn_block_ms"] = cuda_ms(cudnn, 20 if big else 50)
        # its ~8 launches make the event time depend on the host's enqueue
        row["cudnn_block_device_ms"] = device_ms(cudnn, 10)
        row["bound_ms"], row["bound_by"] = block_bound(m, cin, cm)
        row["ratio_to_cudnn"] = row["device_ms"] / row["cudnn_block_device_ms"]
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        report[label] = row
        print(f"block kernel bottleneck_block {label} ({imgs} x {hw}, C {cin}, Cm {cm}): " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
        del args, cudnn
        torch.cuda.empty_cache()
    return {"bottleneck_block": report}


def serving_model(seed: int):
    """ResNet-50 ContrastiveModel in bf16 on the card, eval mode, with random
    weights and BatchNorm affines and running statistics from seed (scale
    1 + N(0, 0.1^2), bias N(0, 0.1^2), mean N(0, 0.1^2), var U(0.5, 1.5)):
    near the init's, so that 16 blocks neither blow up nor vanish, and far
    enough from mean 0 / var 1 to exercise the fold."""
    import torch

    from simhand_tpu_torch.models import ContrastiveModel

    torch.manual_seed(seed)
    return randomize_batchnorm(ContrastiveModel(RESNET, dtype=torch.bfloat16).cuda().eval(),
                               seed)


def serving_detnet(seed: int):
    """Phase 18's ResNet-50 DetNet at SIDE in bf16 on the card, eval mode,
    with random weights and BatchNorm statistics from ``seed + 2``."""
    import torch

    from simhand_tpu_torch.finetune.detnet import DetNet

    torch.manual_seed(seed + 2)
    return randomize_batchnorm(DetNet(RESNET, dtype=torch.bfloat16, hm_res=SIDE // 4).cuda().eval(),
                               seed + 2)


def randomize_batchnorm(model, seed: int):
    """serving_model's BatchNorm affines and running statistics, from seed."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                c = mod.num_features
                mod.weight.copy_(1 + 0.1 * torch.randn(c, device="cuda", generator=gen))
                mod.bias.copy_(0.1 * torch.randn(c, device="cuda", generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(c, device="cuda", generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(c, device="cuda", generator=gen))
    return model


def cosines(a, b):
    import torch

    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=1)


def timed_calls(fn, x, n: int) -> float:
    """ms of one call of fn(x) over n calls, host clock around a sync."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(x)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def serving_path(seed: int) -> tuple[dict, dict, object]:
    """The frozen bf16 serving forward, every convolution on the kernel and
    layer4_1/2 through #12, against the cuDNN walk, the float32 walk and the
    model's eval forward."""
    import torch

    from simhand_tpu_torch.ops import bottleneck_block as BB
    from simhand_tpu_torch.ops import conv_bias as CB
    from simhand_tpu_torch.serving import fold_encoder_f32

    model = serving_model(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    images = torch.randn(SERVE_IMAGES, SIDE, SIDE, 3, device="cuda", generator=gen)
    walks = {"kernel": BB.make_folded_encoder_bf16(model, SERVE_BLOCKS),
             "cudnn": cudnn_walk(model),
             "eval": lambda x: model(x)[0]}
    BB.reset_launches()
    CB.reset_launches()
    emb = walks["kernel"](images)
    torch.cuda.synchronize()
    per_forward = {"bottleneck_block": BB.bottleneck_block.launches,
                   "conv_bias_act": CB.conv_bias_act.launches}
    require(per_forward == {"bottleneck_block": len(SERVE_BLOCKS),
                            "conv_bias_act": CONV_BIAS_PER_FORWARD},
            f"launches in one forward {per_forward}")
    with torch.no_grad():
        cudnn, ev = walks["cudnn"](images), walks["eval"](images)
        f32 = fold_encoder_f32(model)(images)["embedding"]
    require(emb.shape == (SERVE_IMAGES, 2048) and bool(emb.isfinite().all()),
            f"kernel walk embedding {tuple(emb.shape)}, finite {bool(emb.isfinite().all())}")
    scale = float(cudnn.abs().max())
    perf = {"launches_per_forward": per_forward, "embedding_max_abs": scale,
            "kernel_vs_cudnn_rel": float((emb - cudnn).abs().max()) / scale,
            "kernel_vs_f32_rel": float((emb - f32).abs().max()) / float(f32.abs().max()),
            "cudnn_vs_f32_rel": float((cudnn - f32).abs().max()) / float(f32.abs().max()),
            "min_cos_cudnn": float(cosines(emb, cudnn).min()),
            "min_cos_f32": float(cosines(emb, f32).min()),
            "min_cos_eval": float(cosines(emb, ev).min()),
            "cudnn_min_cos_f32": float(cosines(cudnn, f32).min())}
    print("serving forward: " + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                                         for k, v in perf.items()))
    require(perf["kernel_vs_cudnn_rel"] <= SERVE_WALK_RTOL,
            f"kernel walk differs from the cuDNN walk by {perf['kernel_vs_cudnn_rel']:.3e}")
    require(perf["min_cos_cudnn"] > 0.99 and perf["min_cos_f32"] > 0.99
            and perf["min_cos_eval"] > 0.99,
            "kernel walk's embeddings do not track the cuDNN and float32 walks and the eval "
            "forward")
    del cudnn, ev, f32

    times = {k: [] for k in walks}
    with torch.no_grad():
        for name in ("kernel", "cudnn", "eval", "eval", "cudnn", "kernel"):
            times[name].append(timed_calls(walks[name], images, SERVE_TIMED))
    mean_ms = {k: sum(v) / len(v) for k, v in times.items()}
    perf.update({"forward_ms": mean_ms, "img_per_s": {k: SERVE_IMAGES / v * 1e3
                                                      for k, v in mean_ms.items()},
                 "forward_ms_blocks": times,
                 "launches_in_timing": {"bottleneck_block": BB.bottleneck_block.launches,
                                        "conv_bias_act": CB.conv_bias_act.launches}})
    print("serving forward timing (ms per forward of 256 images, in turns): " + ", ".join(
        f"{k} {v:.3f} = {SERVE_IMAGES / v * 1e3:.1f} img/s" for k, v in mean_ms.items())
        + f"; blocks {times}")
    print("serving profile: one step = one forward of the kernel walk")
    perf.update(profile_steps(lambda st, x: (st, walks["kernel"](x)), None, images))
    print("serving profile: one step = one forward of the cuDNN walk")
    perf["cudnn_walk"] = profile_steps(lambda st, x: (st, walks["cudnn"](x)), None, images)
    # the walk's float32 bias adds are gone; the yardstick shows the check sees them
    require(perf["profile_float_add_launches"] == 0,
            f"the kernel walk ran {perf['profile_float_add_launches']} float32 adds a forward")
    require(perf["cudnn_walk"]["profile_float_add_launches"] > 0,
            "the profile shows no float32 add in the cuDNN walk: the check cannot see them")
    return per_forward, perf, walks["kernel"]


def server_phase(forward) -> dict:
    """The micro-batcher and its HTTP handler over the kernel walk on
    127.0.0.1, driven by ``drive_server`` against the direct forward."""
    import threading

    from simhand_tpu_torch.serving import MicroBatcher, make_handler
    from simhand_tpu_torch.serving.embed import _preprocess_fn
    from simhand_tpu_torch.serving.server import _HTTPServer

    batcher = MicroBatcher(lambda x: {"embedding": forward(x)}, SIDE, SERVER_BATCH, 200.0)
    httpd = _HTTPServer(("127.0.0.1", 0), make_handler(batcher))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        perf = drive_server(httpd.server_address[1],
                            lambda padded: forward(_preprocess_fn(SIDE)(padded)).cpu().numpy())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    require(not batcher.thread.is_alive(), "the micro-batcher's executor did not stop")
    return perf


def drive_server(port: int, direct) -> dict:
    """Eight concurrent requests of mixed sizes to the server on
    127.0.0.1:port, each answer checked against ``direct`` (a padded uint8
    batch of SERVER_BATCH crops -> their embedding rows, numpy), /healthz,
    then a burst for requests/s whose answers are checked the same way."""
    import threading
    import urllib.request

    import numpy as np

    from simhand_tpu_torch.serving.server import _nearest_resize

    rng = np.random.default_rng(0)
    sizes = [(128, 128), (96, 160), (200, 200), (64, 64), (128, 100), (150, 90), (128, 128),
             (256, 192)]
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]

    def post(img, out, i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/infer?h={img.shape[0]}&w={img.shape[1]}",
            data=img.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            out[i] = json.loads(resp.read())

    def burst(images):
        out = [None] * len(images)
        threads = [threading.Thread(target=post, args=(img, out, i))
                   for i, img in enumerate(images)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        deadline = time.monotonic() + 300
        for th in threads:
            th.join(timeout=max(0.0, deadline - time.monotonic()))
        require(not any(th.is_alive() for th in threads), "server requests did not finish")
        return out, time.perf_counter() - t0

    results, dt = burst(imgs)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
        require(r.read() == b"ok\n", "/healthz did not answer ok")
    padded = np.zeros((SERVER_BATCH, SIDE, SIDE, 3), np.uint8)
    padded[:len(imgs)] = np.stack([_nearest_resize(img, SIDE) for img in imgs])
    want = direct(padded)

    def row_errors(answers, what):
        """Each answer's distance from the direct forward's row of its
        image; fails on a request left unanswered or a row off by more
        than 1e-4."""
        errs = []
        for i, res in enumerate(answers):
            require(res is not None, f"{what} request {i} was not answered")
            got, ref = np.asarray(res["embedding"], np.float32), want[i % len(imgs)]
            require(got.shape == ref.shape, f"{what} request {i}: row of shape {got.shape}")
            errs.append(float(np.abs(got - ref).max()))
            require(bool(np.allclose(got, ref, rtol=1e-4, atol=1e-4)),
                    f"{what} request {i}: row differs from the direct forward by {errs[-1]}")
        return errs

    errs = row_errors(results, "mixed-size")
    n_burst = 2 * SERVER_BATCH
    many = [imgs[i % len(imgs)] for i in range(n_burst)]
    answers, dt_burst = burst(many)
    burst_errs = row_errors(answers, "burst")
    perf = {"requests": len(imgs), "max_abs_err": max(errs), "first_burst_s": dt,
            "burst_requests": n_burst, "burst_s": dt_burst, "burst_max_abs_err": max(burst_errs),
            "requests_per_s": n_burst / dt_burst}
    print(f"server: {len(imgs)} concurrent requests answered in {dt:.3f} s, rows within "
          f"{max(errs):.3e} of the direct forward; burst of {n_burst} requests, every row "
          f"within {max(burst_errs):.3e} of it, in {dt_burst:.3f} s = "
          f"{n_burst / dt_burst:.1f} requests/s")
    return perf


def op_split_ms(fn, groups: dict, launching: str = "aten::_int_mm", tries: int = 4) -> dict:
    """Device ms of one fn() call by the ATen op that launched each kernel:
    the outermost op whose name one of ``groups`` lists takes the device
    time of everything under it; kernels of no listed op go to "other".
    Every call of the op ``launching`` launches a kernel, so a session
    (profiled_session) in which one of them shows no device time lost
    records and is run again, up to ``tries`` sessions; then the script
    fails."""
    from torch.autograd import DeviceType

    for attempt in range(1, tries + 1):
        prof, _ = profiled_session(fn)
        calls = [e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CPU and e.name == launching]
        if calls and min(calls) > 0:
            break
        print(f"chip_smoke: profiler session {attempt} of {tries} recorded device time for "
              f"{sum(t > 0 for t in calls)} of {len(calls)} {launching} calls", file=sys.stderr)
        time.sleep(1.0)
    else:
        raise SmokeFailure(f"the profiler lost device records of {launching} in every session")
    out = dict.fromkeys([*groups, "other"], 0.0)

    def visit(event):
        for group, names in groups.items():
            if event.name in names:
                out[group] += event.device_time_total / 1e3
                return
        out["other"] += sum(k.duration for k in event.kernels) / 1e3
        for child in event.cpu_children:
            visit(child)

    for event in prof.events():
        if event.device_type == DeviceType.CPU and event.cpu_parent is None:
            visit(event)
    return out


def serving_entry_points(seed: int) -> dict:
    """Phase 18: the serving entry points as a user runs them, at full width
    (ResNet-50, SIDE, B = SERVE_IMAGES): export.main for five artifacts
    (bf16, weight-only int8 and int8_compute encoders from a checkpoint
    directory; bf16 and int8_compute detnets from a detnet.pth; the int8
    ones calibrated on phase 3's cache), load_artifact, embed.main over the
    cache and server.serve behind the micro-batcher, each held to its
    limits; then every artifact, the eval forward and the kernel walk timed
    in turns, and one int8_compute forward's device time split by op."""
    import shutil
    import threading

    import numpy as np
    import torch

    from simhand_tpu_torch import native
    from simhand_tpu_torch.data.cache import CachedHand100MSource
    from simhand_tpu_torch.ops import bottleneck_block as BB
    from simhand_tpu_torch.serving import embed, export, int8_infer, server
    from simhand_tpu_torch.serving.embed import _preprocess_fn
    from simhand_tpu_torch.train.checkpoint import CheckpointManager, export_state_dict
    from simhand_tpu_torch.train.optimizer import Optimizer, OptimizerConfig, decay_mask
    from simhand_tpu_torch.train.state import TrainState

    root = native.BUILD_DIR / f"serving_{seed}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cache = str(native.BUILD_DIR / f"cache_fed_{seed}")
    # the phase starts from an empty allocator cache, whatever blocks the
    # earlier phases left; its timings count the allocator's retries
    torch.cuda.empty_cache()
    # the encoder as pre-training leaves it (a checkpoint directory), the
    # detnet as fine-tuning exports it (a .pth), both with serving_model's
    # random weights and BatchNorm statistics
    model = serving_model(seed)
    state = TrainState(model, Optimizer(OptimizerConfig(), list(model.parameters()),
                                        decay_mask(model)))
    CheckpointManager(str(root / "checkpoints")).save(1, state, {"contrastive_loss": 0.0})
    del state
    det = serving_detnet(seed)
    export_state_dict(det, str(root / "detnet.pth"))

    enc = ["--surface", "encoder", "--backbone", RESNET, "--side", str(SIDE),
           "--checkpoint", str(root / "checkpoints")]
    dnet = ["--surface", "detnet", "--backbone", RESNET, "--side", str(SIDE),
            "--pth", str(root / "detnet.pth")]
    int8c = ["--quantize", "int8_compute", "--calib_cache", cache]
    runs = {"encoder_bf16": enc, "encoder_int8": enc + ["--quantize", "int8"],
            "encoder_int8_compute": enc + int8c, "detnet_bf16": dnet,
            "detnet_int8_compute": dnet + int8c}
    perf = {"artifacts": {}}
    calls, paths = {}, {}
    for name, flags in runs.items():
        paths[name] = str(root / f"{name}.pt2")
        t0 = time.perf_counter()
        export.main([*flags, "--out", paths[name]])
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        calls[name], meta = export.load_artifact(paths[name])
        load_s = time.perf_counter() - t0
        quantize = flags[flags.index("--quantize") + 1] if "--quantize" in flags else None
        require(meta["surface"] == flags[1] and meta["side"] == SIDE
                and meta["batch"] == "poly" and meta["quantize"] == quantize,
                f"artifact {name}: header {meta}")
        mb = (root / f"{name}.pt2").stat().st_size / 1e6
        perf["artifacts"][name] = {"mb": mb, "export_s": export_s, "load_s": load_s}
        print(f"artifact {name}: {mb:.3f} MB; export.main {export_s:.2f} s, "
              f"load_artifact {load_s:.2f} s")

    # calibration as export.main runs it, timed alone; the detnet's W8A8
    # module in memory (its d_map and l_map are not in the artifact)
    t0 = time.perf_counter()
    calib = int8_infer.cache_calibration_batches(cache, side=SIDE, device="cuda")
    perf["calib_read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, report = int8_infer.build_encoder_int8(model, calib_batches=calib)
    torch.cuda.synchronize()
    perf["calibrate_encoder_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    det_int8, det_report = int8_infer.build_detnet_int8(det, RESNET, calib_batches=calib)
    torch.cuda.synchronize()
    perf["calibrate_detnet_s"] = time.perf_counter() - t0
    print(f"calibration: {len(calib)} batches of {calib[0].shape[0]} cache crops read and "
          f"preprocessed in {perf['calib_read_s']:.2f} s; encoder {report['sites']} sites "
          f"calibrated and quantized in {perf['calibrate_encoder_s']:.2f} s, detnet "
          f"{det_report['sites']} in {perf['calibrate_detnet_s']:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    images = torch.randn(SERVE_IMAGES, SIDE, SIDE, 3, device="cuda", generator=gen)
    eval_enc, eval_det = export.build_encoder_forward(model), export.build_detnet_forward(det)
    with torch.no_grad():
        want_enc, want_det = eval_enc(images), det(images)
        f32 = int8_infer.fold_encoder_f32(model)(images)["embedding"]
        rerun = [det_int8(images)["h_map"] for _ in range(2)]
    got = {name: call(images) for name, call in calls.items()}
    # the W8A8 detnet's float32 deconvolutions run on cuDNN's backward-data
    # algorithms, some of which sum in no fixed order: its artifact is held
    # to the module it was exported from with deterministic ones on both
    torch.backends.cudnn.deterministic = True
    try:
        with torch.no_grad():
            det_mem = det_int8(images)
        got_det_int8 = calls["detnet_int8_compute"](images)
    finally:
        torch.backends.cudnn.deterministic = False

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    c = {"encoder_bf16_rel": max(rel(got["encoder_bf16"][k], want_enc[k]) for k in want_enc),
         "detnet_bf16_rel": max(rel(got["detnet_bf16"][k], want_det[k])
                                for k in ("h_map", "xyz", "delta")),
         "detnet_bf16_uv_equal": bool((got["detnet_bf16"]["uv"] == want_det["uv"]).all()),
         "int8_min_cos": float(cosines(got["encoder_int8"]["embedding"],
                                       got["encoder_bf16"]["embedding"]).min()),
         "int8_size_share": (perf["artifacts"]["encoder_int8"]["mb"]
                             / perf["artifacts"]["encoder_bf16"]["mb"]),
         "int8_compute_min_cos_f32": float(cosines(got["encoder_int8_compute"]["embedding"],
                                                   f32).min()),
         "detnet_int8_artifact_rel": {k: rel(got_det_int8[k], det_mem[k])
                                      for k in ("h_map", "xyz", "delta")},
         "detnet_int8_artifact_uv_equal": bool((got_det_int8["uv"] == det_mem["uv"]).all()),
         "detnet_int8_rerun_h_map_rel": rel(rerun[1], rerun[0]),
         "detnet_int8_h_map_abs": float((got["detnet_int8_compute"]["h_map"]
                                         - got["detnet_bf16"]["h_map"]).abs().max())}
    for k in ("d_map", "l_map"):
        c[f"detnet_int8_{k}_abs"] = float((det_mem[k] - want_det[k]).abs().max())
        c[f"detnet_int8_{k}_limit"] = DETNET_INT8_ATOL * max(1.0, float(want_det[k].abs().max()))
    cpu_call, _ = export.load_artifact(paths["encoder_int8_compute"], "cpu")
    sub = images[:INT8_CPU_IMAGES]
    on_cpu, on_card = cpu_call(sub.cpu()), calls["encoder_int8_compute"](sub)
    c["int8_compute_card_vs_cpu_rel"] = {k: rel(on_card[k].cpu(), on_cpu[k]) for k in on_cpu}
    finite = {k: bool(v.float().isfinite().all()) for k, v in got["detnet_int8_compute"].items()}
    print("serving entry points: " + " ".join(f"{k}={v}" for k, v in c.items()))
    require(c["encoder_bf16_rel"] <= ARTIFACT_RTOL and c["detnet_bf16_rel"] <= ARTIFACT_RTOL
            and c["detnet_bf16_uv_equal"],
            "a bf16 artifact differs from the eval forward it was exported from")
    require(c["int8_min_cos"] > QUANT_MIN_COS and c["int8_size_share"] <= QUANT_SIZE_SHARE,
            "the weight-only int8 artifact is off the bf16 one or not small enough")
    require(c["int8_compute_card_vs_cpu_rel"]["embedding"] <= ARTIFACT_RTOL,
            "the int8_compute artifact on the card is off its CPU run")
    require(c["int8_compute_min_cos_f32"] > INT8_F32_MIN_COS,
            "the int8_compute embedding does not track the float32 fold")
    require(max(c["detnet_int8_artifact_rel"].values()) <= ARTIFACT_RTOL
            and c["detnet_int8_artifact_uv_equal"],
            "the int8_compute detnet artifact differs from the module it was exported from")
    require(c["detnet_int8_h_map_abs"] < DETNET_INT8_ATOL
            and all(c[f"detnet_int8_{k}_abs"] < c[f"detnet_int8_{k}_limit"]
                    for k in ("d_map", "l_map")) and all(finite.values()),
            f"the int8_compute detnet is off the bf16 one (finite {finite})")
    perf["checks"] = c
    del want_enc, want_det, f32, det_mem, got, got_det_int8, rerun, on_cpu, on_card

    # embed.main over the cache against the artifact on the same crops
    out = root / "embeddings.npy"
    perf["embed"] = embed.main(["--artifact", paths["encoder_bf16"], "--cache", cache,
                                "--batch", str(SERVE_IMAGES), "--out", str(out)])
    crops = CachedHand100MSource(cache).gather_crops(np.arange(CACHE_IMAGES))
    pre = _preprocess_fn(SIDE)
    want = torch.cat([calls["encoder_bf16"](pre(crops[lo:lo + SERVE_IMAGES]))["embedding"]
                      for lo in range(0, CACHE_IMAGES, SERVE_IMAGES)])
    perf["embed"]["rel"] = rel(torch.from_numpy(np.load(out)), want.cpu())
    print(f"embed.main: {CACHE_IMAGES} crops at batch {SERVE_IMAGES}, "
          f"{perf['embed']['images_per_sec']:.1f} images/s ({perf['embed']['seconds']:.3f} s), "
          f"rows within rel {perf['embed']['rel']:.3e} of the artifact's")
    require(perf["embed"]["rel"] <= ARTIFACT_RTOL, "embed.main's rows are off the artifact's")

    # server.serve from the bf16 artifact, in a thread, at the CLI's max_wait_ms
    ready, failure = threading.Event(), []

    def run_server():
        try:
            server.serve(paths["encoder_bf16"], 0, SERVER_BATCH, 5.0, ready=ready)
        except BaseException as exc:     # reported below; the phase then fails
            failure.append(exc)
            ready.set()

    thread = threading.Thread(target=run_server, daemon=True)
    thread.start()
    require(ready.wait(300) and not failure, f"server.serve did not start: {failure}")
    try:
        perf["server"] = drive_server(
            ready.httpd.server_address[1],
            lambda padded: calls["encoder_bf16"](pre(padded))["embedding"].float().cpu().numpy())
    finally:
        ready.httpd.shutdown()
        thread.join(timeout=60)
    require(not thread.is_alive() and not failure, f"server.serve did not stop: {failure}")

    # in turns at B = SERVE_IMAGES
    kernel_walk = BB.make_folded_encoder_bf16(model, SERVE_BLOCKS)
    walks = {"encoder_bf16_artifact": calls["encoder_bf16"], "eval_forward": eval_enc,
             "encoder_int8_artifact": calls["encoder_int8"],
             "encoder_int8_compute_artifact": calls["encoder_int8_compute"],
             "kernel_walk": kernel_walk, "detnet_bf16_artifact": calls["detnet_bf16"],
             "detnet_int8_compute_artifact": calls["detnet_int8_compute"]}
    times = {k: [] for k in walks}
    retries = torch.cuda.memory_stats()["num_alloc_retries"]
    with torch.no_grad():
        kernel_walk(images)
        for name in [*walks, *reversed(walks)]:
            times[name].append(timed_calls(walks[name], images, SERVE_TIMED))
    perf["alloc_retries_in_turns"] = torch.cuda.memory_stats()["num_alloc_retries"] - retries
    perf["forward_ms"] = {k: sum(v) / len(v) for k, v in times.items()}
    perf["forward_ms_turns"] = times
    perf["img_per_s"] = {k: SERVE_IMAGES / v * 1e3 for k, v in perf["forward_ms"].items()}
    print(f"serving entry points, ms per forward of {SERVE_IMAGES} images in turns: " + ", ".join(
        f"{k} {v:.3f} = {perf['img_per_s'][k]:.1f} img/s" for k, v in perf["forward_ms"].items())
        + f"; turns {times}; allocator retries {perf['alloc_retries_in_turns']}")
    perf["int8_compute_device_ms"] = op_split_ms(
        lambda: calls["encoder_int8_compute"](images), INT8_OP_GROUPS)
    print("int8_compute forward, device ms by op: " + ", ".join(
        f"{k} {v:.3f}" for k, v in perf["int8_compute_device_ms"].items()))
    return perf


# phase 19, mining at scripts/mine_scale_bench.py's cell: MINE_N hands,
# keypoints uniform in [0, 1) and video ids in [0, MINE_VIDEOS) from --seed,
# k = 1, chunks of MINE_CHUNK; the first MINE_CPU_QUERIES queries against the
# whole database on the CPU (chunks of MINE_CPU_CHUNK: the result does not
# depend on the chunks); a tie corpus of TIE_N hands on the integer grid
# {0, 1, 2, 3}, copies of TIE_POSES poses over TIE_VIDEOS videos, k = 3, ragged
# chunks, card against CPU; the mining CLI on the first MINE_CLI_N hands
MINE_N, MINE_VIDEOS, MINE_CHUNK = 100_000, 5_000, 8192
MINE_CPU_QUERIES, MINE_CPU_CHUNK = 1024, 2048
MINE_PROFILE_DB_CHUNKS = 2     # the profiled query chunk's database, in chunks
TIE_N, TIE_POSES, TIE_VIDEOS, TIE_K, TIE_QUERY_CHUNK, TIE_DB_CHUNK = 4096, 512, 64, 3, 1000, 1536
MINE_CLI_N = 16_384
MINE_PROJECTED_N = 2_000_000   # the corpus the JAX script projects to
# per (query, database) element and joint: the float32 operations a fused
# pass needs (2 differences, 2 products, the add, the root, the sum), and
# the bytes the port's route moves (_chunk_distances: ten passes over
# (Q, C) planes of float32 and float64)
MINE_FUSED_OPS, MINE_ROUTE_BYTES = 7, 120
# the loader: raw simhand_w pairs of SyntheticHandSource(LOADER_IMAGES, side
# CROP), batches of LOADER_BATCH, at each worker count up to the host's cores
LOADER_IMAGES, LOADER_BATCH, LOADER_WORKERS = 2048, 256, (0, 1, 2, 4, 8)


def _mining_dir(seed: int):
    from simhand_tpu_torch import native

    return native.BUILD_DIR / f"mining_{seed}"


def same_bits(a, b) -> bool:
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        (a.view(np.uint8) == b.view(np.uint8)).all())


def mining_path(seed: int) -> dict:
    """Phase 19's mining: the library call at the scale cell (cold and warm,
    hands/s, validity, the CPU on the first queries), the distance pass's
    device ms by kernel beside its bound, the tie corpus, the CLI."""
    import numpy as np
    import torch

    from simhand_tpu_torch import native
    from simhand_tpu_torch.data.grain_loader import start_worker_server
    from simhand_tpu_torch.device import resolve_device
    from simhand_tpu_torch.mining import run as mining_run
    from simhand_tpu_torch.mining import similar_hands as S

    # the loader's fork server imports torch (~8 s) in a process of its own
    # while mining runs on the card, outside the loader's timed epochs
    start_worker_server()
    rng = np.random.default_rng(seed)
    kp = rng.uniform(0, 1, size=(MINE_N, 21, 2)).astype(np.float32)
    vids = rng.integers(0, MINE_VIDEOS, size=MINE_N).astype(np.int32)
    kw = dict(k=1, query_chunk=MINE_CHUNK, db_chunk=MINE_CHUNK)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i = S.mine_similar_hands(kp, vids, **kw)
        runs.append((time.perf_counter() - t0, d, i))
    (cold_s, d, i), (warm_s, d2, i2) = runs
    require(same_bits(d, d2) and same_bits(i, i2), "two mining runs differ")
    require(d.shape == (MINE_N, 1) and d.dtype == np.float32 and i.dtype == np.int32,
            f"mining gave {d.shape} {d.dtype} / {i.dtype}")
    require(bool((i >= 0).all()) and bool(np.isfinite(d).all()),
            "a hand without a valid positive, or a distance not finite")
    require(bool((vids[i[:, 0]] != vids).all()), "a pair from the same video")
    require(bool((i[:, 0] != np.arange(MINE_N)).all()), "a hand paired with itself")
    _mining_dir(seed).mkdir(parents=True, exist_ok=True)
    np.savez(_mining_dir(seed) / "single.npz", d=d, i=i)    # phase 21's reference
    t = torch.from_numpy
    q = MINE_CPU_QUERIES
    t0 = time.perf_counter()
    cd, ci = S.topk_similar(t(kp[:q]), t(vids[:q]), torch.arange(q, dtype=torch.int32),
                            t(kp), t(vids), k=1, db_chunk=MINE_CPU_CHUNK)
    cpu_s = time.perf_counter() - t0
    require(same_bits(d[:q], cd.numpy()) and same_bits(i[:q], ci.numpy()),
            f"the card's first {q} queries differ from the CPU's: "
            f"{int((d[:q] != cd.numpy()).sum())} distances, "
            f"{int((i[:q] != ci.numpy()).sum())} indices")

    # the distance pass's tiles: one query chunk against the first database
    # chunks (all full), by kernel, a tile's share
    dev = resolve_device()
    qk, qv = t(kp[:MINE_CHUNK]).to(dev), t(vids[:MINE_CHUNK]).to(dev)
    qi = torch.arange(MINE_CHUNK, dtype=torch.int32, device=dev)
    n_db = MINE_PROFILE_DB_CHUNKS * MINE_CHUNK
    dbk, dbv = t(kp[:n_db]).to(dev), t(vids[:n_db]).to(dev)
    by_kernel = {name: ms / MINE_PROFILE_DB_CHUNKS for name, ms in device_ms_by_kernel(
        lambda: S.topk_similar(qk, qv, qi, dbk, dbv, k=1, db_chunk=MINE_CHUNK), 1).items()}
    tile_ms = sum(by_kernel.values())
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8])
    tiles = -(-MINE_N // MINE_CHUNK)
    padded = tiles * MINE_CHUNK
    pass_device_ms = tile_ms * tiles * tiles
    floor_ms = MINE_N * MINE_N * 21 * MINE_FUSED_OPS / FP32_OPS_PER_S * 1e3
    route_bytes = padded * padded * 21 * MINE_ROUTE_BYTES
    route_bytes_ms = route_bytes / HBM_BYTES_PER_S * 1e3
    projected_s = warm_s * (MINE_PROJECTED_N / MINE_N) ** 2
    print(f"mining {MINE_N} hands (k=1, chunks {MINE_CHUNK}): cold {cold_s:.3f} s, warm "
          f"{warm_s:.3f} s -> {MINE_N / warm_s:.1f} hands/s; every pair valid; the first {q} "
          f"queries equal the CPU's bit for bit (CPU {cpu_s:.2f} s); projected "
          f"{MINE_PROJECTED_N} hands: {projected_s:.1f} s")
    print(f"mining distance pass: {tile_ms:.3f} device ms a tile of {MINE_CHUNK} x "
          f"{MINE_CHUNK}, {pass_device_ms:.1f} ms for the pass ({tiles}^2 tiles); bound "
          f"{floor_ms:.2f} ms "
          f"(a fused pass, {MINE_FUSED_OPS} float32 operations an element a joint); the "
          f"route moves {route_bytes / 1e12:.2f} TB, {route_bytes_ms:.1f} ms at the HBM rate")
    for name, ms in top.items():
        print(f"  {ms:9.3f} ms  {name[:110]}")

    # the tie corpus: card against CPU
    trng = np.random.default_rng(seed + 1)
    base = trng.integers(0, 4, size=(TIE_POSES, 21, 2)).astype(np.float32)
    tkp = base[trng.integers(0, TIE_POSES, size=TIE_N)]
    tvids = trng.integers(0, TIE_VIDEOS, size=TIE_N).astype(np.int32)
    tkw = dict(k=TIE_K, query_chunk=TIE_QUERY_CHUNK, db_chunk=TIE_DB_CHUNK)
    want_d, want_i = S.mine_similar_hands(tkp, tvids, device="cpu", **tkw)
    got_d, got_i = S.mine_similar_hands(tkp, tvids, **tkw)
    require(same_bits(got_d, want_d) and same_bits(got_i, want_i),
            "the tie corpus on the card differs from the CPU")
    ties = int((np.diff(want_d, axis=1) == 0).sum())
    require(ties > 0, "the tie corpus holds no tie")
    print(f"mining tie corpus ({TIE_N} hands on the grid {{0..3}}, k={TIE_K}, chunks "
          f"{TIE_QUERY_CHUNK}/{TIE_DB_CHUNK}): card == CPU bit for bit; "
          f"{ties} equal neighbours in the top {TIE_K}")

    # the CLI on an unpaired JSON of nested <video>/frame_x.jpg names
    out_dir = _mining_dir(seed)
    n = MINE_CLI_N
    images = [{"id": j, "file_name": f"frames/video{int(vids[j]):04d}/frame_{j:06d}.jpg",
               "width": CROP, "height": CROP} for j in range(n)]
    annotations = [{"image_id": j, "hand_id": j, "left_right": "Right",
                    "keypoint_25d": np.concatenate([kp[j], np.zeros((21, 1), np.float32)],
                                                   1).reshape(-1).tolist(),
                    "positive_sample": [], "distance": []} for j in range(n)]
    src, dst = out_dir / "unpaired.json", out_dir / "paired.json"
    src.write_text(json.dumps({"images": images, "annotations": annotations}))
    t0 = time.perf_counter()
    mining_run.main(["--input", str(src), "--output", str(dst), "--k", "1",
                     "--query_chunk", str(MINE_CHUNK), "--db_chunk", str(MINE_CHUNK)])
    cli_s = time.perf_counter() - t0
    # no other run of the phase mines these n hands among themselves
    t0 = time.perf_counter()
    lib_d, lib_i = S.mine_similar_hands(kp[:n], vids[:n], **kw)
    lib_s = time.perf_counter() - t0
    mined = json.loads(dst.read_text())["annotations"]
    require([a["positive_sample"] for a in mined] == lib_i.tolist(),
            "the mining CLI's positives differ from the library call's")
    require(same_bits(np.asarray([a["distance"] for a in mined], np.float32), lib_d),
            "the mining CLI's distances differ from the library call's")
    print(f"mining CLI on {n} annotations: {cli_s:.2f} s, positives equal to the library "
          f"call's ({lib_s:.2f} s)")
    return {"hands": MINE_N, "cold_s": cold_s, "warm_s": warm_s,
            "hands_per_s": MINE_N / warm_s, "cpu_queries_s": cpu_s,
            "tile_device_ms": tile_ms, "pass_device_ms": pass_device_ms,
            "device_ms_by_kernel": top, "bound_ms": floor_ms, "bound_by": "operations",
            "route_bytes": route_bytes, "route_bytes_ms": route_bytes_ms,
            "projected_2m_s": projected_s, "tie_equal_neighbours": ties, "cli_s": cli_s,
            "cli_library_s": lib_s}


def loader_phase(seed: int) -> dict:
    """Phase 19's loader: raw pair batches of the synthetic corpus through
    grain_batch_iterator at each worker count. The serial epoch's samples
    equal raw_pair bit for bit; every other count gives the same samples,
    each equal to the serial one bit for bit."""
    import os

    import numpy as np

    from simhand_tpu_torch.data.augment_cv2 import AugmentFlags, AugmentParams
    from simhand_tpu_torch.data.grain_loader import grain_batch_iterator
    from simhand_tpu_torch.data.pipeline import PretrainDataset
    from simhand_tpu_torch.data.sources import SyntheticHandSource

    t0 = time.perf_counter()
    src = SyntheticHandSource(LOADER_IMAGES, side=CROP, seed=seed)
    corpus_s = time.perf_counter() - t0
    ds = PretrainDataset(src, "simhand_w", AugmentFlags(crop=True, resize=True, rotate=True),
                         AugmentParams(), seed=seed)
    index = {hash(src.images[j].tobytes()): j for j in range(LOADER_IMAGES)}
    require(len(index) == LOADER_IMAGES, "two synthetic crops are equal")
    cores = os.cpu_count() or 1
    ref, row_of, perf = None, None, {}
    for workers in (w for w in LOADER_WORKERS if w <= cores):
        t0 = time.perf_counter()
        batches, first_s = [], None
        for b in grain_batch_iterator(ds, LOADER_BATCH, seed=seed, epoch=1,
                                      num_workers=workers, raw=True):
            batches.append(b)
            first_s = first_s or time.perf_counter() - t0
        seconds = time.perf_counter() - t0
        after_first = sum(len(b["image1"]) for b in batches[1:]) / (seconds - first_s)
        got = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
        seen = [index[hash(img.tobytes())] for img in got["image1"]]
        require(len(seen) == len(set(seen)), f"a sample twice in an epoch ({workers} workers)")
        if ref is None:
            for r, j in enumerate(seen):
                want = ds.raw_pair(j)
                require(all(same_bits(got[k][r], want[k]) for k in want),
                        f"sample {j} of the serial epoch differs from raw_pair")
            ref, row_of = got, {j: r for r, j in enumerate(seen)}
        require(sorted(seen) == sorted(row_of), f"{workers} workers gave another epoch than serial")
        rows = [row_of[j] for j in seen]
        require(all(same_bits(got[k], ref[k][rows]) for k in ref),
                f"a sample from {workers} workers differs from the serial one")
        perf[workers] = {"pairs_per_s": len(seen) / seconds, "first_batch_s": first_s,
                         "pairs_per_s_after_first": after_first, "seconds": seconds}
        print(f"loader: {workers} workers, {len(seen)} raw pairs in {seconds:.3f} s = "
              f"{len(seen) / seconds:.1f} pairs/s (start-up included; first batch after "
              f"{first_s:.3f} s, {after_first:.1f} pairs/s after it)")
    print(f"loader: os.cpu_count() = {cores}; the synthetic corpus built in {corpus_s:.2f} s")
    return {"workers": perf, "cpu_count": cores, "samples": len(row_of), "corpus_s": corpus_s}

# phase 20, the encoder's last options and the data-parallel step. In this
# process: the s2d stem against conv7 with s2d_stem_kernel's weights
# (float32, TF32 off, S2D_IMAGES images at SIDE), the bf16 step with each
# stem, and remat against the same step without it (cuDNN deterministic);
# then, in processes of their own: the NCCL group at world size 1 (the
# sharded step against the single-device step, DP_W1_STEPS steps), and
# DP_WORLD ranks on the one card over gloo (NCCL refuses two ranks on one
# device): the loss layer on this process's projections, the whole step
# with cross-replica BatchNorm (kernel and dense routes, DP_STEPS steps), the
# per-replica statistics against the serial oracle, DP_CONV_STEPS steps
# with conv1x1_fuse_min_cin, timings. Every child shares DP_DEADLINE_S.
S2D_IMAGES, S2D_RTOL, ENCODER_STEPS = 64, 1e-5, 3
# remat's parameter gradients against the step's without it, relative to
# each tensor's largest: the recomputed forward runs the same cuDNN
# algorithms (deterministic mode) on the same inputs, so it is expected bit
# for bit; the limit leaves room for a kernel that sums in another order
REMAT_GRAD_RTOL = 1e-5
DP_WORLD, DP_STEPS, DP_CONV_STEPS, DP_W1_STEPS, DP_TIMED = 2, 3, 2, 2, 3
DP_DEADLINE_S = 150
# the loss layer: the sharded loss against the single-device loss on the
# same projections, and each rank's dz against the global dz (x1 on the
# kernel route, x DP_WORLD on the dense one) relative to its largest
DP_LOSS_RTOL, DP_DZ_RTOL = 1e-5, 1e-5
# the whole step's step-0 loss against the single-process step on the
# global batch, and against _split_head_oracle's loss in bf16. Two bf16
# forwards whose BatchNorm statistics differ in their last bits diverge at
# this random init: cross-replica BatchNorm forms the variance as
# E[x^2] - mu^2 in float32 from the ranks' sums where cuDNN's batch_norm
# takes it in one pass, and 53 BatchNorm outputs rounded to bf16 carry that
# on (the two-rank embeddings 8.4e-2 in norm from the oracle's, where
# float32 gives 3.4e-5; the step-0 loss 4.91e-4 from the oracle's on an
# H100). The single process departs further (6.10e-4): the projection
# head's BatchNorm1d is per-replica in both packages, so each rank
# normalises it over its 256 rows where one process does over 512
DP_STEP_LOSS_RTOL = 1e-3
# the sync, held where rounding does not diverge: a float32 forward (TF32
# off) of the two ranks against _split_head_oracle's, each rank's encoder
# embeddings relative to the oracle's largest (7.3e-5 on an H100, where
# per-replica BatchNorm gives 0.18) and the sharded loss relative (3.1e-7,
# where one process's, with the head over every row, is 8.5e-5 away)
DP_EMB_RTOL, DP_ORACLE_LOSS_RTOL = 3e-4, 1e-5
# per-replica statistics against the serial oracle (tests/test_train.py:247)
DP_ORACLE_RTOL, DP_ORACLE_ATOL = 2e-3, 2e-4


def s2d_stem_check(seed: int) -> float:
    """The s2d stem against the conv7 stem with s2d_stem_kernel's weights in
    float32 (TF32 off): the largest difference over the largest output."""
    import torch

    from simhand_tpu_torch.models.layers import Conv2d
    from simhand_tpu_torch.models.resnet import s2d_stem_kernel, space_to_depth

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(S2D_IMAGES, SIDE, SIDE, 3, device="cuda", generator=gen)
    w7 = torch.randn(64, 3, 7, 7, device="cuda", generator=gen) / 12
    conv7 = Conv2d(3, 64, 7, 2, padding=3).cuda()
    s2d = Conv2d(12, 64, 4, 1, padding=((2, 1), (2, 1))).cuda()
    with torch.no_grad():
        conv7.weight.copy_(w7)
        s2d.weight.copy_(s2d_stem_kernel(w7))
        want = conv7(x.permute(0, 3, 1, 2))
        got = s2d(space_to_depth(x, 2).permute(0, 3, 1, 2))
    return rel_largest(got, want)


def encoder_options_path(seed: int, batch) -> dict:
    """The s2d stem and remat on the bf16 simhand_w step at B = PAIRS."""
    import torch

    from simhand_tpu_torch.ops import conv1x1 as C
    from simhand_tpu_torch.train import make_train_step

    cfg = step_config()
    err = s2d_stem_check(seed)
    print(f"s2d stem vs conv7 (float32, {S2D_IMAGES} images): max diff {err:.3e} of the largest")
    require(err <= S2D_RTOL, f"the s2d stem departs {err} from conv7 with its kernel's weights")
    states = {"conv7": new_state(seed), "s2d": new_state(seed, stem="space_to_depth")}
    steps = {k: make_train_step(s.model, cfg) for k, s in states.items()}
    losses = {}
    for k in states:
        states[k], losses[k] = run_steps(steps[k], states[k], batch, k, steps=ENCODER_STEPS)
    stem_ms = {k: [] for k in states}
    for k in ("conv7", "s2d", "s2d", "conv7"):
        states[k], _, dt = timed(steps[k], states[k], batch, ENCODER_STEPS)
        stem_ms[k].append(dt * 1e3)
    stem_ms = {k: sum(v) / len(v) for k, v in stem_ms.items()}
    print(f"stems: losses {losses}; ms/step in turns {stem_ms}")
    del states, steps

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = {"plain": new_state(seed), "remat": new_state(seed, remat=True)}
        first = {k: step0(s, batch, cfg) for k, s in states.items()}
        (lp, gp), (lr, gr) = first["plain"], first["remat"]
        names = [n for n, _ in states["plain"].model.named_parameters()]
        worst = max((float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)), n)
                    for a, b, n in zip(gr, gp, names))
        equal = sum(torch.equal(a, b) for a, b in zip(gr, gp))
        stats = [(n, a, b) for (n, a), b in zip(states["remat"].model.named_buffers(),
                                                 states["plain"].model.buffers())
                 if "running" in n]
        stats_equal = all(torch.equal(a, b) for _, a, b in stats)
        print(f"remat step 0: loss {lr!r} vs {lp!r}; gradients bit-equal {equal}/{len(gp)}, "
              f"worst {worst[1]} {worst[0]:.3e} of its largest; running statistics equal "
              f"{stats_equal}")
        require(lr == lp, f"remat's step-0 loss {lr} differs from the plain step's {lp}")
        require(worst[0] <= REMAT_GRAD_RTOL, f"remat's gradients depart {worst}")
        require(stats_equal, "remat's running statistics differ from the plain step's: "
                             "the recomputed forward updated them")
        del first, gp, gr
        steps = {k: make_train_step(s.model, cfg) for k, s in states.items()}
        peak, remat_ms = {}, {k: [] for k in states}
        for k in states:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            states[k], _ = run_steps(steps[k], states[k], batch, f"{k} (remat check)", steps=1)
            peak[k] = torch.cuda.max_memory_allocated() / 2**30
        for k in ("plain", "remat", "remat", "plain"):
            states[k], _, dt = timed(steps[k], states[k], batch, ENCODER_STEPS)
            remat_ms[k].append(dt * 1e3)
        remat_ms = {k: sum(v) / len(v) for k, v in remat_ms.items()}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"remat: peak GiB allocated {peak}; ms/step in turns {remat_ms}")
    del states, steps

    # remat with the fused conv1x1 sites: the recomputed forward launches #10 again
    state = new_state(seed, remat=True, conv1x1_fuse_min_cin=CONV_FUSE_MIN_CIN)
    C.reset_launches()
    state, _ = run_steps(make_train_step(state.model, cfg), state, batch, "remat conv1x1",
                         steps=1)
    launches = C.conv1x1_stats.launches
    print(f"remat with conv1x1_fuse_min_cin={CONV_FUSE_MIN_CIN}: #10 launches a step {launches}")
    require(launches == 2 * CONV_PER_STEP,
            f"#10 launched {launches} times in a remat step, not {2 * CONV_PER_STEP} "
            f"(the forward's {CONV_PER_STEP} and the recomputation's)")
    return {"s2d_stem_rel_err": err, "stem_losses": losses, "stem_ms": stem_ms,
            "remat_loss0": lr, "remat_grad_worst_rel": worst[0], "remat_grads_bit_equal": equal,
            "remat_peak_gib": peak, "remat_ms": remat_ms, "remat_conv1x1_launches": launches}


def _replicated_bits(axis, model) -> bool:
    """Whether this rank's parameters and buffers equal rank 0's bit for bit."""
    import torch

    flat = torch.cat([t.detach().reshape(-1).float() for t in
                      (*model.parameters(), *model.buffers())])
    return bool(axis.reduce_raw(torch.tensor(0.0 if torch.equal(flat, axis.broadcast(flat))
                                             else 1.0, device=flat.device), "max") == 0)


def _rank_rows(rank: int, n: int):
    """The global rows of rank's [view1; view2] when each rank holds n pairs."""
    import torch

    return torch.cat([torch.arange(n), PAIRS + torch.arange(n)]).cuda() + rank * n


def _split_head_oracle(seed: int, batch, dtype) -> dict:
    """The function the DP_WORLD-rank step computes, in one process: the
    whole batch through the encoder (its BatchNorm over every row, as
    cross-replica BatchNorm gives it), then the projection head on each
    rank's rows alone (its BatchNorm is per-replica). Returns the encoder's
    embeddings ("emb") and those projections ("proj") in the global row
    order, the head on every row at once ("whole", one process's
    projections), and each rank's rows through the encoder alone ("alone",
    per-replica BatchNorm)."""
    import torch

    model = new_state(seed, dtype).model.train()
    n = PAIRS // DP_WORLD
    images = torch.cat([batch["transformed_image1"], batch["transformed_image2"]])
    with torch.no_grad():
        emb = model.encoder(images)
        heads = [model.projection_head(emb[_rank_rows(r, n)]) for r in range(DP_WORLD)]
        alone = [model.encoder(images[_rank_rows(r, n)]) for r in range(DP_WORLD)]
        whole = model.projection_head(emb)
    return {"emb": emb, "proj": torch.cat([h[:n] for h in heads] + [h[n:] for h in heads]),
            "whole": whole, "alone": alone}


def _dp_forward_oracle(axis, seed: int, batch, local) -> tuple[dict, object]:
    """Each rank's forward with cross-replica BatchNorm against the oracle
    of the same function: the encoder embeddings (float32 held, bf16
    printed) and, in float32, the sharded loss. Returns the record and
    the bf16 oracle's projections."""
    import torch

    from simhand_tpu_torch.models import contrastive_loss_from_projections

    cfg, rows = step_config(), _rank_rows(axis.index, PAIRS // axis.size)
    images = torch.cat([local["transformed_image1"], local["transformed_image2"]])
    out = {}
    for name, dtype in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        oracle = _split_head_oracle(seed, batch, dtype)
        want = oracle["emb"][rows]
        probe = new_state(seed, dtype, bn_axis=axis).model.train()
        with torch.no_grad():
            got, proj = probe(images)
            loss = float(contrastive_loss_from_projections(proj, local, cfg, axis)[0])
            oracle_loss = float(contrastive_loss_from_projections(oracle["proj"], batch, cfg)[0])
            single_loss = float(contrastive_loss_from_projections(oracle["whole"], batch, cfg)[0])
        scale, norm = float(want.abs().max()), float(want.norm())
        alone = oracle["alone"][axis.index]
        out[name] = {
            "emb": float((got - want).abs().max()) / scale,
            "emb_per_replica": float((alone - want).abs().max()) / scale,
            "emb_norm": float((got - want).norm()) / norm,
            "emb_per_replica_norm": float((alone - want).norm()) / norm,
            "loss": loss, "oracle_loss": oracle_loss, "single_loss": single_loss,
            "loss_rel": abs(loss - oracle_loss) / abs(oracle_loss),
            "single_rel": abs(loss - single_loss) / abs(single_loss)}
        del want, probe, got, proj, alone
    f32 = out["float32"]
    require(f32["emb"] <= DP_EMB_RTOL,
            f"rank {axis.index}: float32 embeddings depart {f32['emb']} from the oracle's")
    require(f32["loss_rel"] <= DP_ORACLE_LOSS_RTOL,
            f"rank {axis.index}: float32 loss {f32['loss']} against the oracle's "
            f"{f32['oracle_loss']}")
    return out, oracle["proj"]


def _dp_loss_layer(axis, batch, proj) -> dict:
    """The sharded loss of each family and route against the single-device
    loss on the same projections: values, dz with its scale, launches."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import contrastive_loss_from_projections
    from simhand_tpu_torch.parallel import shard_batch

    rows = _rank_rows(axis.index, PAIRS // axis.size)
    local = shard_batch(axis, batch)
    out = {}
    for family, kernels in (("simhand_w", ("weighted_ntxent_denominator", "weighted_grad_rows")),
                            ("simhand-base", ("ntxent_denominator", "ntxent_grad"))):
        for route in ("kernel", "dense"):
            cfg = step_config(experiment_type=family, use_pallas=route == "kernel")
            p = proj.clone().requires_grad_()
            loss_g, _ = contrastive_loss_from_projections(p, batch, cfg)
            dz_g = torch.autograd.grad(loss_g, p)[0][rows] * (1 if route == "kernel"
                                                             else axis.size)
            K.reset_launches()
            p = proj[rows].clone().requires_grad_()
            loss, _ = contrastive_loss_from_projections(p, local, cfg, axis)
            dz = torch.autograd.grad(loss, p)[0]
            launches = {fn.__name__: fn.launches for fn in K.KERNELS}
            rel = abs(float(loss) - float(loss_g)) / abs(float(loss_g))
            dz_err = float((dz - dz_g).abs().max() / dz_g.abs().max())
            key = f"{family}_{route}"
            out[key] = {"loss": float(loss), "single_loss": float(loss_g), "rel": rel,
                        "dz_rel": dz_err, "launches": launches}
            require(rel <= DP_LOSS_RTOL, f"rank {axis.index} {key}: loss departs {rel}")
            require(dz_err <= DP_DZ_RTOL, f"rank {axis.index} {key}: dz departs {dz_err}")
            want = {k: int(route == "kernel" and k in kernels) for k in launches}
            require(launches == want, f"rank {axis.index} {key}: launches {launches}, not {want}")
    return out


def _dp_rank(seed: int, rank: int, port: int, proj_file: str) -> dict:
    """One of DP_WORLD ranks on the one card (phase 20)."""
    import datetime

    import torch
    import torch.distributed as dist

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import contrastive_loss_from_projections
    from simhand_tpu_torch.ops import conv1x1 as C
    from simhand_tpu_torch.parallel import create_mesh, shard_batch
    from simhand_tpu_torch.train import make_train_step
    from simhand_tpu_torch.train.loop import pmean_tensors

    timeout = datetime.timedelta(seconds=DP_DEADLINE_S)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=DP_WORLD, timeout=timeout)
    axis = create_mesh()
    out = {"rank": rank}
    batch = synthetic_batch(seed)
    out["loss_layer"] = _dp_loss_layer(axis, batch, torch.load(proj_file).cuda())
    local = shard_batch(axis, batch)

    out["forward"], proj_oracle = _dp_forward_oracle(axis, seed, batch, local)

    for route in ("kernel", "dense"):
        cfg = step_config(use_pallas=route == "kernel")
        with torch.no_grad():
            oracle0 = float(contrastive_loss_from_projections(proj_oracle, batch, cfg)[0])
        if rank == 0:
            ref = new_state(seed)
            single0 = float(make_train_step(ref.model, cfg)(ref, batch)[1]["contrastive_loss"])
            del ref
        state = new_state(seed, bn_axis=axis)
        step = make_train_step(state.model, cfg, axis=axis)
        K.reset_launches()
        losses, replicated = [], []
        for _ in range(DP_STEPS):
            state, metrics = step(state, local)
            losses.append(float(metrics["contrastive_loss"]))
            replicated.append(_replicated_bits(axis, state.model))
        launches = {fn.__name__: fn.launches for fn in K.KERNELS}
        rec = {"losses": losses, "replicated": replicated, "launches": launches,
               "oracle_loss0": oracle0, "oracle_rel": abs(losses[0] - oracle0) / abs(oracle0)}
        require(all(math.isfinite(v) for v in losses), f"rank {rank} {route}: losses {losses}")
        require(rec["oracle_rel"] <= DP_STEP_LOSS_RTOL,
                f"{route} two-rank step-0 loss {losses[0]} against the oracle's {oracle0}")
        require(all(replicated), f"rank {rank} {route}: the ranks' states differ after a step")
        if rank == 0:
            rec.update(single_loss0=single0, loss0_rel=abs(losses[0] - single0) / abs(single0))
            require(rec["loss0_rel"] <= DP_STEP_LOSS_RTOL,
                    f"{route} two-rank step-0 loss {losses[0]} against one process's {single0}")
        if route == "kernel":
            require(launches["weighted_ntxent_denominator"] == DP_STEPS
                    and launches["weighted_grad_rows"] == DP_STEPS,
                    f"rank {rank}: #2/#4 launches {launches}")
            torch.cuda.synchronize()
            axis.reduce_raw(torch.zeros(1, device="cuda"), "sum")
            t0 = time.perf_counter()
            for _ in range(DP_TIMED):
                state, metrics = step(state, local)
            float(metrics["contrastive_loss"])
            rec["step_ms"] = (time.perf_counter() - t0) / DP_TIMED * 1e3
            grads = [p.detach().clone() for p in state.params]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_TIMED):
                pmean_tensors(axis, grads)
            torch.cuda.synchronize()
            rec["grad_pmean_ms"] = (time.perf_counter() - t0) / DP_TIMED * 1e3
            rec["grad_mb"] = sum(g.numel() for g in grads) * 4 / 1e6
            z = torch.randn(2 * PAIRS // DP_WORLD, 128, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_TIMED):
                axis.gather_raw(z)
            torch.cuda.synchronize()
            rec["z_gather_ms"] = (time.perf_counter() - t0) / DP_TIMED * 1e3
            del grads
        out[f"step_{route}"] = rec
        del state, step
    del proj_oracle

    # per-replica BatchNorm: the step's statistics against the serial oracle
    state = new_state(seed)
    init = copy.deepcopy(state.model.state_dict())
    state, _ = make_train_step(state.model, step_config(), axis=axis)(state, local)
    got = {k: v.clone() for k, v in state.model.state_dict().items()
           if k.endswith(("_mean", "_var"))}
    oracle_err = 0.0
    if rank == 0:
        shards = []
        for r in range(DP_WORLD):
            state.model.load_state_dict(init)
            state.model.train()
            rows = slice(r * PAIRS // DP_WORLD, (r + 1) * PAIRS // DP_WORLD)
            with torch.no_grad():
                state.model(torch.cat([batch["transformed_image1"][rows],
                                       batch["transformed_image2"][rows]]))
            shards.append({k: v.clone() for k, v in state.model.state_dict().items()
                           if k in got})
        for k, v in got.items():
            want = sum(s[k] for s in shards) / DP_WORLD
            ok = torch.allclose(v, want, rtol=DP_ORACLE_RTOL, atol=DP_ORACLE_ATOL)
            oracle_err = max(oracle_err, float((v - want).abs().max()))
            require(ok, f"per-replica statistics {k} differ from the serial oracle's mean")
    out["per_replica_oracle_max_abs"] = oracle_err
    del state, init

    # the fused conv1x1 sites with cross-replica statistics: #10 on each rank
    state = new_state(seed, bn_axis=axis, conv1x1_fuse_min_cin=CONV_FUSE_MIN_CIN)
    step = make_train_step(state.model, step_config(), axis=axis)
    C.reset_launches()
    losses = []
    for _ in range(DP_CONV_STEPS):
        state, metrics = step(state, local)
        losses.append(float(metrics["contrastive_loss"]))
    launches = {fn.__name__: fn.launches for fn in C.KERNELS}
    out["conv1x1"] = {"losses": losses, "launches": launches,
                      "replicated": _replicated_bits(axis, state.model)}
    require(all(math.isfinite(v) for v in losses), f"rank {rank} conv1x1 losses {losses}")
    require(launches == {"conv1x1_stats": CONV_PER_STEP * DP_CONV_STEPS,
                         "conv1x1_bn_relu_stats": 0}, f"rank {rank}: #10 launches {launches}")
    require(out["conv1x1"]["replicated"], f"rank {rank}: conv1x1 states differ")
    del state, step
    dist.destroy_process_group()

    # NCCL and two ranks on one device
    torch.cuda.synchronize()
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port + 1}", rank=rank,
                                world_size=DP_WORLD, timeout=datetime.timedelta(seconds=30))
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out["nccl_two_ranks_one_card"] = f"not refused (sum {float(t)})"
    except RuntimeError as exc:
        out["nccl_two_ranks_one_card"] = f"{type(exc).__name__}: {exc}"[:400]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def _dp_world1(seed: int, port: int) -> dict:
    """The NCCL group at world size 1: the sharded step with the real axis
    against the single-device step, bit for bit."""
    import datetime

    import torch
    import torch.distributed as dist

    from simhand_tpu_torch.parallel import create_mesh, shard_batch
    from simhand_tpu_torch.train import make_train_step

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=DP_DEADLINE_S),
                            device_id=torch.device("cuda", 0))
    axis = create_mesh()
    agreed = [axis.any_rank(False), axis.any_rank(True)]
    require(agreed == [False, True], f"NCCL world 1: host flags agreed as {agreed}")
    cfg, batch = step_config(), synthetic_batch(seed)
    states = {"single": new_state(seed), "sharded": new_state(seed)}
    steps = {"single": make_train_step(states["single"].model, cfg),
             "sharded": make_train_step(states["sharded"].model, cfg, axis=axis)}
    batches = {"single": batch, "sharded": shard_batch(axis, batch)}
    losses = {k: [] for k in states}
    for _ in range(DP_W1_STEPS):
        for k in states:
            states[k], metrics = steps[k](states[k], batches[k])
            losses[k].append(float(metrics["contrastive_loss"]))
    sd = {k: s.model.state_dict() for k, s in states.items()}
    differ = [k for k in sd["single"] if not torch.equal(sd["single"][k], sd["sharded"][k])]
    dist.destroy_process_group()
    require(losses["single"] == losses["sharded"],
            f"NCCL world 1: losses {losses['sharded']} against {losses['single']}")
    require(not differ, f"NCCL world 1: {len(differ)} tensors differ, e.g. {differ[:3]}")
    return {"losses": losses["sharded"], "tensors_equal": len(sd["single"]),
            "host_flags": agreed}


def dp_child(role: str, seed: int, rank: int, port: int, out: str, proj_file: str) -> int:
    """The entry of phase 20's and phase 21's processes: writes its result
    as JSON to out."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    result = {"world1": lambda: _dp_world1(seed, port),
              "rank": lambda: _dp_rank(seed, rank, port, proj_file),
              "sharded_world1": lambda: _sharded_world1(seed, port),
              "sharded_rank": lambda: _sharded_rank(seed, rank, port)}[role]()
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(args_list: list, deadline: float) -> list:
    """Starts one process of this script for each argument list, all
    together; waits for all within the shared deadline, kills any left, and
    fails unless every one exits 0. Returns their outputs."""
    procs = [subprocess.Popen([sys.executable, __file__, *a], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for a in args_list]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                logs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for a, p, log in zip(args_list, procs, logs):
        if p.returncode != 0:
            print(log[-6000:])
        require(p.returncode == 0, f"process {a} exited {p.returncode}")
    return logs


def data_parallel_phase(seed: int) -> tuple[dict, dict]:
    """Phase 20: the encoder options here, then the NCCL world-1 process
    and the DP_WORLD gloo ranks. Returns the phase's record and the
    sharded launches of each kernel a rank a step."""
    import pathlib

    import torch

    t0 = time.perf_counter()
    batch = synthetic_batch(seed)
    perf = encoder_options_path(seed, batch)
    state = new_state(seed)
    state.model.train()
    with torch.no_grad():
        proj = state.model(torch.cat([batch["transformed_image1"],
                                      batch["transformed_image2"]]))[1]
    work = pathlib.Path(__file__).resolve().parent / "build" / f"data_parallel_{seed}"
    work.mkdir(parents=True, exist_ok=True)
    torch.save(proj.cpu(), work / "proj.pt")
    del state, batch, proj
    torch.cuda.empty_cache()
    deadline = time.monotonic() + DP_DEADLINE_S

    common = ["--seed", str(seed), "--dp-proj", str(work / "proj.pt")]
    t1 = time.perf_counter()
    _run_children([["--dp-role", "world1", "--dp-port", str(_free_port()),
                    "--dp-out", str(work / "world1.json"), *common]], deadline)
    world1 = json.loads((work / "world1.json").read_text())
    print(f"NCCL world 1: sharded step == single-device step bit for bit over "
          f"{DP_W1_STEPS} steps (losses {world1['losses']}, {world1['tensors_equal']} "
          f"tensors); host flags over gloo {world1['host_flags']}; "
          f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    port = _free_port()
    logs = _run_children([["--dp-role", "rank", "--dp-rank", str(r), "--dp-port", str(port),
                           "--dp-out", str(work / f"rank{r}.json"), *common]
                          for r in range(DP_WORLD)], deadline)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]
    ranks_s = time.perf_counter() - t1
    r0 = ranks[0]
    print(f"two ranks on one card: NCCL {r0['nccl_two_ranks_one_card']!r}; gloo took the "
          f"CUDA tensors of all_gather, all_reduce and broadcast")
    for r in ranks:
        for name, e in r["forward"].items():
            print(f"rank {r['rank']} {name} forward against the oracle's: embeddings, "
                  f"cross-replica BN {e['emb']:.3e} of the largest ({e['emb_norm']:.3e} in norm), "
                  f"per-replica BN {e['emb_per_replica']:.3e} ({e['emb_per_replica_norm']:.3e}); "
                  f"loss {e['loss']:.7f}, rel {e['loss_rel']:.2e} to the oracle's, "
                  f"{e['single_rel']:.2e} to one process's")
    for r in ranks:
        for key, v in r["loss_layer"].items():
            print(f"rank {r['rank']} loss layer {key}: loss {v['loss']:.7f} (one device "
                  f"{v['single_loss']:.7f}, rel {v['rel']:.2e}); dz rel {v['dz_rel']:.2e}; "
                  f"launches {v['launches']}")
    for route in ("kernel", "dense"):
        s = r0[f"step_{route}"]
        print(f"two-rank step ({route} route, cross-replica BN): losses {s['losses']}; step 0 "
              f"rel {s['loss0_rel']:.2e} to one process's {s['single_loss0']:.7f}, rel "
              f"{s['oracle_rel']:.2e} to the oracle's {s['oracle_loss0']:.7f}; replicated "
              f"{[r[f'step_{route}']['replicated'] for r in ranks]}")
    sk = r0["step_kernel"]
    print(f"two processes sharing one card (no scaling claim): {sk['step_ms']:.2f} ms/step "
          f"(B = {PAIRS} pairs, {PAIRS // DP_WORLD} a rank); the gradient pmean "
          f"({sk['grad_mb']:.1f} MB) {sk['grad_pmean_ms']:.2f} ms, z all_gather "
          f"{sk['z_gather_ms']:.3f} ms over gloo")
    print(f"per-replica statistics vs the serial oracle: max abs diff "
          f"{r0['per_replica_oracle_max_abs']:.3e}; conv1x1 steps {r0['conv1x1']}")
    phase_s = time.perf_counter() - t0
    print(f"phase 20 (encoder options, data-parallel step): {phase_s:.1f} s, of it the two "
          f"ranks {ranks_s:.1f} s")
    launches = {name: sum(v["launches"].get(name, 0) for v in r0["loss_layer"].values())
                for name in ("ntxent_denominator", "weighted_ntxent_denominator",
                             "ntxent_grad", "weighted_grad_rows")}
    launches["conv1x1_stats"] = r0["conv1x1"]["launches"]["conv1x1_stats"] // DP_CONV_STEPS
    perf.update(world1=world1, ranks=ranks, phase_s=phase_s, ranks_s=ranks_s,
                rank_logs_tail=[log[-2000:] for log in logs])
    return perf, launches


# phase 21, the rest of the sharded work, after phase 19: this script
# started again as processes of their own. The NCCL group at world size 1
# (the FSDP step against the single-device step, SH_W1_STEPS steps, bit for
# bit), then SH_WORLD ranks on the one card over gloo, each running in turn:
# FSDP (ResNet-50, SIDE, bf16, B = PAIRS pairs, simhand_w on the kernel
# route: #2/#4 on row shards; FSDP_STEPS steps against one process's step,
# the bytes each rank holds, FSDP_TIMED timed steps, the gather and the
# reduce-scatter alone; one step with conv1x1_fuse_min_cin: #10 at the
# synced sites; FSDP_F32_STEPS float32 steps against one process's), the
# data-parallel detnet step (ResNet-50 DetNet, 128x128, bf16, DET_BATCH
# images, fused_pallas: #9 on each rank, each launch held against its plain
# version; DET_STEPS steps and DET_TIMED timed; one float32 step against the
# per-replica oracle) and sharded mining at phase 19's cell (the replicated
# database and the ring). Every child shares SH_DEADLINE_S.
SH_WORLD, SH_W1_STEPS, SH_DEADLINE_S = 2, 2, 420
FSDP_STEPS, FSDP_TIMED = 3, 3
# the bf16 FSDP step-0 loss against one process's step on the global batch
# (its BatchNorms, the head's too, over every row, as the FSDP step's are):
# phase 20's reason for DP_STEP_LOSS_RTOL, less the per-replica head: the
# variance as E[x^2] - mu^2 from the ranks' sums where cuDNN takes it in one
# pass, carried on by 54 bf16 BatchNorm outputs (phase 20 measured 4.91e-4
# for that alone)
FSDP_LOSS_RTOL = 1e-3
# float32 (TF32 off), FSDP against one process on the global batch, each
# loss within FSDP_F32_LOSS_RTOL (phase 20's float32 loss against its
# oracle, 3.1e-7; measured 3.1e-7), in two optimizer settings; rounding at
# this random init moves the gradient by percents, so one process against
# itself with its pairs reversed (the same function summed in another
# order) is printed beside each check as its floor. (a) The smoke's own
# (lr 0 at step 0), one step: Adam's mu is 0.1 x the gradient, held
# relative to its norm over all tensors but projection_head.fc1.bias (0 up
# to rounding) at FSDP_F32_MU_RTOL, half the 0.5 by which a scale fault of
# the reduce-scatter is off at two ranks (measured 2.45e-2 on an H100; the
# first limit tried, 1e-2, failed there). Its LARS trust ratio is clipped
# to 1 on every leaf (lr 3.2e-7 at step 1), so LARS's norms go unread
# there. (b) LARS unclipped (lars_clip=False: every leaf's gradient scaled
# by eta |p| / (|g| + wd |p|) from step 0), FSDP_F32_STEPS steps: mu and nu
# after the last step, each relative to its norm over the same tensors,
# held at FSDP_F32_LARS_RTOL, between the floor and the control: the same
# FSDP run with the gradient norm of each split leaf taken on its piece
# alone (a psum missing on one side of the trust ratio), whose mu must
# depart beyond the limit, so the check can fail. On an H100: mu 2.05e-2
# (floor 1.49e-2, control 0.284), nu 2.50e-2 (floor 1.74e-2, control
# 4.66e-2: nu is ruled by the small whole leaves, so its control is not
# required). Both norms of the piece (the psum missing on both sides)
# moved mu by 3e-4 only: the trust ratio is a ratio of norms, and a
# piece's two norms shrink together. The parameters' change after the
# last step (lr 3.2e-7 times Adam's direction, near its sign) is printed
# (0.150 from one process, floor 0.127, control 0.150) and required
# finite only: it reads the gradient's signs, which rounding flips
FSDP_F32_LOSS_RTOL, FSDP_F32_MU_RTOL, FSDP_F32_STEPS = 1e-5, 0.25, 2
FSDP_F32_LARS_RTOL = 0.1
# FSDP through the fused BatchNorm modes: each rank's kernels #5-#9 on its
# rows, their per-channel sums all-reduced over the ranks (one collective a
# site forward, one backward); FSDP_FUSED_STEPS checked steps (every
# reduce's sums against its plain version, the BN kernel phase's limit) and
# FSDP_FUSED_TIMED timed ones a mode; float32 at FSDP_F32_LOSS_RTOL and
# FSDP_F32_MU_RTOL against one process, a per-replica control above the mu
# limit
FSDP_FUSED, FSDP_FUSED_STEPS, FSDP_FUSED_TIMED = ("pallas", "epilogue"), 2, 2
FSDP_FUSED_PER_STEP = {"pallas": {"bn_backward_reduces": FUSED_BN_PER_STEP},
                       "epilogue": BN_PER_STEP}
FSDP_SUMS_RTOL = 1e-5
DET_BATCH, DET_STEPS, DET_TIMED = 128, 3, 3
# #9 against its plain version at each launch (phase 17's limit); the
# float32 step's parts against the per-replica oracle (the same function:
# the ranks' pmean of W x their rows' share against one backward), and its
# pmean'd gradient: all tensors together, and each tensor above 1e-3 of the
# largest tensor's norm, relative to its norm. The gradient's limits are
# rounding carried back through 53 train-mode BatchNorm backwards over 64
# images (measured 2.6e-4 together, 3.3e-4 the worst tensor on an H100; the
# first limit tried, 1e-4 together, failed there); a missing pmean or a
# heatmap term averaged over the wrong rows is off by O(1)
DET_SUMS_RTOL, DET_PARTS_RTOL, DET_GRAD_RTOL, DET_TENSOR_RTOL = 1e-5, 1e-5, 2e-3, 1e-2
# the ring's queries emulated on the CPU in rotation order: the first of
# each rank's shard
SH_CPU_QUERIES = 256


def _fsdp_arm(axis, seed: int) -> dict:
    """FSDP on this rank: bf16 steps with #2/#4, bytes, timings, #10 at the
    synced conv1x1 sites, float32 against one process."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.ops import conv1x1 as C
    from simhand_tpu_torch.parallel import make_fsdp_train_step, state_bytes
    from simhand_tpu_torch.train import make_schedule, make_train_step

    rank, cfg, batch = axis.index, step_config(), synthetic_batch(seed)
    out = {}
    if rank == 0:
        ref = new_state(seed)
        out["single_loss0"] = float(make_train_step(ref.model, cfg)(ref, batch)[1]
                                    ["contrastive_loss"])
        del ref
        torch.cuda.empty_cache()
    state = new_state(seed)
    whole = state_bytes(state)
    step, place_state, place_batch = make_fsdp_train_step(state.model, cfg, axis, state)
    state = place_state(state)
    local = place_batch(batch)
    out.update(whole_bytes=whole, held_bytes=state_bytes(state))
    require(out["held_bytes"] < 0.55 * whole,
            f"rank {rank} holds {out['held_bytes']} of the state's {whole} bytes")
    K.reset_launches()
    losses = []
    for _ in range(FSDP_STEPS):
        state, metrics = step(state, local)
        losses.append(float(metrics["contrastive_loss"]))
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    out.update(losses=losses, launches=launches)
    require(all(math.isfinite(v) for v in losses), f"rank {rank} FSDP losses {losses}")
    want = {k: FSDP_STEPS * (k in ("weighted_ntxent_denominator", "weighted_grad_rows"))
            for k in launches}
    require(launches == want, f"rank {rank}: FSDP launches {launches}, not {want}")
    if rank == 0:
        out["loss0_rel"] = abs(losses[0] / out["single_loss0"] - 1)
        require(out["loss0_rel"] <= FSDP_LOSS_RTOL,
                f"FSDP step-0 loss {losses[0]} against one process's {out['single_loss0']}")
    state, _, dt = timed(step, state, local, FSDP_TIMED)
    out["step_ms"] = dt * 1e3
    flat = torch.zeros(sum(s.numel() for s, d in zip(state.shards, state.dims)
                           if d is not None) * axis.size, device="cuda")
    for name, fn in (("gather_ms", state.gather_params),
                     ("reduce_scatter_ms", lambda: state.mesh.fsdp.scatter_raw(flat))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FSDP_TIMED):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / FSDP_TIMED * 1e3
    out["split_mb"] = flat.numel() * 4 / 1e6
    del state, step, flat
    torch.cuda.empty_cache()

    # #10 at the synced conv1x1 sites under FSDP
    state = new_state(seed, conv1x1_fuse_min_cin=CONV_FUSE_MIN_CIN)
    step, place_state, _ = make_fsdp_train_step(state.model, cfg, axis, state)
    state = place_state(state)
    C.reset_launches()
    state, metrics = step(state, local)
    out["conv1x1"] = {"loss": float(metrics["contrastive_loss"]),
                      "launches": {fn.__name__: fn.launches for fn in C.KERNELS}}
    require(out["conv1x1"]["launches"] == {"conv1x1_stats": CONV_PER_STEP,
                                           "conv1x1_bn_relu_stats": 0},
            f"rank {rank}: #10 under FSDP {out['conv1x1']}")
    del state, step
    torch.cuda.empty_cache()

    out["f32"] = _fsdp_f32(axis, seed, cfg, batch, local)
    return out


def _f32_run(state, step, batch: dict, steps: int) -> dict:
    """``steps`` float32 steps of ``step`` from ``state``: the losses, mu
    after the first step, and mu, nu and the parameters' change after the
    last (whole tensors: a collective on every rank for an FSDP state)."""
    names = [n for n, _ in state.model.named_parameters()]

    def snap():
        p = state.payload()
        return ([p["model"][n].clone() for n in names],
                *([t.clone() for t in p["optimizer"][k]] for k in ("mu", "nu")))

    before, losses, mu0 = snap()[0], [], None
    for i in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["contrastive_loss"]))
        if i == 0:
            mu0 = snap()[1]
    after, mu, nu = snap()
    return {"names": names, "losses": losses, "mu0": mu0, "mu": mu, "nu": nu,
            "dp": [a - b for a, b in zip(after, before)]}


def run_rel(key: str, a: dict, b: dict) -> float:
    """The distance of run a's tensors ``key`` from run b's (``_f32_run``
    records) relative to b's norm, over all tensors but
    projection_head.fc1.bias (it feeds a train-mode BatchNorm: its gradient
    is 0 up to rounding)."""
    held = [(x, y) for n, x, y in zip(a["names"], a[key], b[key])
            if n != "projection_head.fc1.bias"]
    return (sum(float((x - y).double().square().sum()) for x, y in held)
            / sum(float(y.double().square().sum()) for _, y in held)) ** 0.5


def _fsdp_f32(axis, seed: int, cfg, batch: dict, local: dict) -> dict | None:
    """FSDP in float32 against one process's step in the two settings of
    FSDP_F32_*; the record on rank 0, None on the others."""
    import torch

    from simhand_tpu_torch.parallel import make_fsdp_train_step
    from simhand_tpu_torch.train import make_train_step

    unclipped = {"lars_clip": False}

    def fsdp(steps, opt=None, piece_norms=False):
        state = new_state(seed, torch.float32, opt)
        step, place_state, _ = make_fsdp_train_step(state.model, cfg, axis, state)
        state = place_state(state)
        if piece_norms:
            # the control: each split leaf's gradient norm of its piece alone
            norms = state.optimizer._global_norms
            state.optimizer._global_norms = lambda p, g: (norms(p, g)[0], g)
        rec = _f32_run(state, step, local, steps)
        del state, step
        torch.cuda.empty_cache()
        return rec

    def single(steps, opt=None, reverse=False):
        state = new_state(seed, torch.float32, opt)
        rows = {k: v.flip(0) for k, v in batch.items()} if reverse else batch
        rec = _f32_run(state, make_train_step(state.model, cfg), rows, steps)
        del state
        torch.cuda.empty_cache()
        return rec

    got = {"a": fsdp(1), "b": fsdp(FSDP_F32_STEPS, unclipped),
           "control": fsdp(FSDP_F32_STEPS, unclipped, piece_norms=True)}
    for name, rec in got.items():
        require(all(math.isfinite(v) for v in rec["losses"])
                and all(bool(t.isfinite().all()) for t in rec["dp"]),
                f"rank {axis.index}: float32 FSDP run {name} not finite")
    if axis.index != 0:
        return None
    want = {"a": single(1), "b": single(FSDP_F32_STEPS, unclipped)}
    floor = {"a": single(1, reverse=True), "b": single(FSDP_F32_STEPS, unclipped, reverse=True)}

    loss_rel = max(abs(x / y - 1) for k in want
                   for x, y in zip(got[k]["losses"], want[k]["losses"]))
    rec = {"losses": {k: got[k]["losses"] for k in got},
           "single_losses": {k: want[k]["losses"] for k in want}, "loss_rel": loss_rel,
           "a_mu0_rel": run_rel("mu0", got["a"], want["a"]),
           "a_mu0_floor": run_rel("mu0", floor["a"], want["a"])}
    for key in ("mu", "nu", "dp"):
        rec[f"b_{key}_rel"] = run_rel(key, got["b"], want["b"])
        rec[f"b_{key}_floor"] = run_rel(key, floor["b"], want["b"])
        rec[f"b_{key}_control"] = run_rel(key, got["control"], want["b"])
    require(loss_rel <= FSDP_F32_LOSS_RTOL, f"float32 FSDP losses {rec['losses']} against "
            f"one process's {rec['single_losses']}")
    require(rec["a_mu0_rel"] <= FSDP_F32_MU_RTOL,
            f"float32 FSDP gradient (mu after step 0) departs {rec['a_mu0_rel']} from one "
            f"process's (one process against itself, pairs reversed: {rec['a_mu0_floor']})")
    for key in ("mu", "nu"):
        r, fl, c = (rec[f"b_{key}_{x}"] for x in ("rel", "floor", "control"))
        require(r <= FSDP_F32_LARS_RTOL,
                f"float32 FSDP {key} under unclipped LARS departs {r} from one process's "
                f"(floor {fl}, control {c}, limit {FSDP_F32_LARS_RTOL})")
    require(rec["b_mu_control"] > FSDP_F32_LARS_RTOL,
            f"the control (piece gradient norms) departs only {rec['b_mu_control']} in mu: "
            f"the check at {FSDP_F32_LARS_RTOL} cannot tell it (floor {rec['b_mu_floor']})")
    return rec


def _plain_reduce(name: str, planes, consts):
    """The plain version of the reduce ``name`` (#5, #7 or #9) on the planes
    and constants of its launch: (sum dy, sum dy*xhat)."""
    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.models import fused_bn as FB

    if name == "dual_reduce":
        return FB.bn_backward_reduces_plain(planes[1], planes[0], consts["mu"], consts["inv"])
    if name == "masked_dual_reduce":
        return E.masked_dual_reduce_plain(*planes, **consts)
    return E.masked_dual_reduce_res_plain(*planes, **consts)[:2]


def _fsdp_fused_arm(axis, seed: int) -> dict:
    """FSDP through each fused BatchNorm mode of FSDP_FUSED on this rank:
    launches a step, each reduce's sums against its plain version, ms/step
    and the BatchNorms' all-reduces alone, float32 against one process and
    the per-replica control (on rank 0; None on the others)."""
    import torch

    from simhand_tpu_torch.models import bn_epilogue as E
    from simhand_tpu_torch.models import fused_bn as FB
    from simhand_tpu_torch.parallel import make_fsdp_train_step
    from simhand_tpu_torch.train import make_train_step

    rank, cfg, batch = axis.index, step_config(), synthetic_batch(seed)
    kernels = (*E.KERNELS, *FB.KERNELS)
    real_reduce, real_stats, real_sums = E._reduce, E.batch_stats, E.global_sums
    out = {}
    for bn_fused in FSDP_FUSED:
        state = new_state(seed, bn_fused=bn_fused)
        step, place_state, place_batch = make_fsdp_train_step(state.model, cfg, axis, state)
        state, local = place_state(state), place_batch(batch)
        errs, sizes = [], []

        def checked(name, planes, consts, *more_outs):
            got = real_reduce(name, planes, consts, *more_outs)
            want = _plain_reduce(name, planes, consts)
            errs.append(max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                            for a, b in zip(got, want)))
            return got

        # the fused sites' all-reduces: the forward's statistics and the
        # backward's sums, C channels each
        def stats(x, eps, axis=None):
            sizes.append(x.shape[1])
            return real_stats(x, eps, axis)

        def sums(axis, sum_dy, sum_dyx):
            sizes.append(sum_dy.shape[0])
            return real_sums(axis, sum_dy, sum_dyx)

        E._reduce, E.batch_stats, E.global_sums = checked, stats, sums
        for fn in kernels:
            fn.launches = 0
        losses = []
        try:
            for _ in range(FSDP_FUSED_STEPS):
                state, metrics = step(state, local)
                losses.append(float(metrics["contrastive_loss"]))
        finally:
            E._reduce, E.batch_stats, E.global_sums = real_reduce, real_stats, real_sums
        launches = {fn.__name__: fn.launches // FSDP_FUSED_STEPS for fn in kernels}
        want = {k: FSDP_FUSED_PER_STEP[bn_fused].get(k, 0) for k in launches}
        rec = {"losses": losses, "launches": launches, "sums_rel": max(errs),
               "reduces": len(errs) // FSDP_FUSED_STEPS,
               "bn_allreduces": len(sizes) // FSDP_FUSED_STEPS}
        require(all(math.isfinite(v) for v in losses), f"rank {rank} FSDP {bn_fused} {losses}")
        require(launches == want, f"rank {rank}: FSDP {bn_fused} launches a step {launches}, "
                f"not {want}")
        require(rec["sums_rel"] <= FSDP_SUMS_RTOL, f"rank {rank}: FSDP {bn_fused} sums against "
                f"their plain versions {rec['sums_rel']}")
        require(rec["bn_allreduces"] == 2 * rec["reduces"], f"rank {rank}: FSDP {bn_fused} "
                f"all-reduced {rec['bn_allreduces']} times a step over {rec['reduces']} sites")
        state, _, dt = timed(step, state, local, FSDP_FUSED_TIMED)
        rec["step_ms"] = dt * 1e3
        # the same all-reduces alone, in the step's order
        bufs = [torch.zeros(2, c, device=state.shards[0].device)
                for c in sizes[:rec["bn_allreduces"]]]
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in bufs:
                axis.reduce_raw(b, "sum")
            torch.cuda.synchronize()
        rec["bn_allreduce_ms"] = (time.perf_counter() - t0) * 1e3
        rec["bn_allreduce_share"] = rec["bn_allreduce_ms"] / rec["step_ms"]
        del state, step, bufs
        torch.cuda.empty_cache()

        # float32: one step against one process's, and the per-replica control
        def f32(per_replica):
            st = new_state(seed, torch.float32, bn_fused=bn_fused)
            st_step, st_place, _ = make_fsdp_train_step(st.model, cfg, axis, st)
            if per_replica:
                st.model.sync_batch_norms(None)
            run = _f32_run(st_place(st), st_step, local, 1)
            torch.cuda.empty_cache()
            return run

        got, control = f32(False), f32(True)
        if rank == 0:
            single = new_state(seed, torch.float32, bn_fused=bn_fused)
            one = _f32_run(single, make_train_step(single.model, cfg), batch, 1)
            del single
            torch.cuda.empty_cache()
            rec["f32"] = {"loss": got["losses"][0], "single_loss": one["losses"][0],
                          "loss_rel": abs(got["losses"][0] / one["losses"][0] - 1),
                          "mu_rel": run_rel("mu0", got, one), "control_loss_rel":
                          abs(control["losses"][0] / one["losses"][0] - 1),
                          "control_mu_rel": run_rel("mu0", control, one)}
            f = rec["f32"]
            require(f["loss_rel"] <= FSDP_F32_LOSS_RTOL and f["mu_rel"] <= FSDP_F32_MU_RTOL,
                    f"float32 FSDP {bn_fused} against one process: {f}")
            require(f["control_mu_rel"] > FSDP_F32_MU_RTOL, f"the per-replica control of "
                    f"FSDP {bn_fused} departs only {f['control_mu_rel']} in mu: the check at "
                    f"{FSDP_F32_MU_RTOL} cannot tell it")
        del got, control
        out[bn_fused] = rec
    return out


def _det_batch(seed: int) -> dict:
    """A global detnet batch of DET_BATCH images made on the card from
    seed: 3 of every 4 samples 3D."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = DET_BATCH
    return {"img": torch.randn(n, 128, 128, 3, device="cuda", generator=gen),
            "hm": torch.rand(n, 32, 32, 21, device="cuda", generator=gen),
            "dm": torch.randn(n, 32, 32, 21, 3, device="cuda", generator=gen),
            "lm": torch.randn(n, 32, 32, 21, 3, device="cuda", generator=gen),
            "hm_veil": torch.ones(n, 21, device="cuda"),
            "flag_3d": torch.tensor([1.0, 1.0, 0.0, 1.0] * (n // 4), device="cuda")}


def _det_state(seed: int, dtype):
    import torch

    from simhand_tpu_torch.finetune.detnet import DetNet
    from simhand_tpu_torch.finetune.train import init_detnet
    from simhand_tpu_torch.train.optimizer import Adam
    from simhand_tpu_torch.train.state import TrainState

    model = DetNet(RESNET, dtype=dtype, bn_fused="pallas")
    init_detnet(model, seed)
    model.to(torch.device("cuda"))
    return TrainState(model, Adam([(list(model.parameters()), lambda count: 1e-4)]))


def _detnet_arm(axis, seed: int) -> dict:
    """The data-parallel detnet step on this rank: #9 every launch checked,
    timings, and a float32 step against the per-replica oracle."""
    import torch

    from simhand_tpu_torch.finetune.detloss import det_loss
    from simhand_tpu_torch.finetune.train import make_detnet_train_step
    from simhand_tpu_torch.models import fused_bn as FB
    from simhand_tpu_torch.parallel import shard_batch

    rank, batch = axis.index, _det_batch(seed)
    local = shard_batch(axis, batch)
    state = _det_state(seed, torch.bfloat16)
    step = make_detnet_train_step(state.model, axis)
    real_launch, errs = FB._launch, []

    def checked_launch(x2d, dy2d, mu, inv):
        got = real_launch(x2d, dy2d, mu, inv)
        want = FB.bn_backward_reduces_plain(x2d, dy2d, mu, inv)
        errs.append(max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                        for a, b in zip(got, want)))
        return got

    FB._launch = checked_launch
    FB.reset_launches()
    parts = []
    try:
        for _ in range(DET_STEPS):
            state, p = step(state, local)
            parts.append(float(p["det_total"]))
    finally:
        FB._launch = real_launch
    launches = FB.bn_backward_reduces.launches
    out = {"det_total": parts, "launches": launches, "sums_rel": max(errs)}
    require(all(math.isfinite(v) for v in parts), f"rank {rank} detnet det_total {parts}")
    require(launches == FUSED_BN_PER_STEP * DET_STEPS and len(errs) == launches,
            f"rank {rank}: #9 launched {launches} times in {DET_STEPS} steps")
    require(out["sums_rel"] <= DET_SUMS_RTOL, f"rank {rank}: #9 against its plain version "
            f"{out['sums_rel']}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DET_TIMED):
        state, p = step(state, local)
    float(p["det_total"])
    out["step_ms"] = (time.perf_counter() - t0) / DET_TIMED * 1e3
    del state, step
    torch.cuda.empty_cache()

    # float32: the ranks' step against the per-replica oracle in one process
    state = _det_state(seed, torch.float32)
    step = make_detnet_train_step(state.model, axis)
    seen, real_step = {}, state.optimizer.step

    def recording(grads):
        seen["grads"] = [g.clone() for g in grads]
        real_step(grads)

    state.optimizer.step = recording
    state, p = step(state, local)
    got_parts = {k: float(v) for k, v in p.items()}
    del state, step
    torch.cuda.empty_cache()
    if rank == 0:
        oracle = _det_state(seed, torch.float32).model.train()
        n = DET_BATCH // axis.size
        preds = [oracle(batch["img"][r * n:(r + 1) * n]) for r in range(axis.size)]
        preds = {k: torch.cat([q[k] for q in preds]) for k in ("h_map", "d_map", "l_map")}
        total, want_parts = det_loss(preds, batch["hm"], batch["dm"], batch["lm"],
                                     batch["hm_veil"], batch["flag_3d"])
        want = torch.autograd.grad(total, list(oracle.parameters()))
        parts_rel = max(abs(got_parts[k] / float(v.detach()) - 1)
                        for k, v in want_parts.items())
        diff = sum(float((g - w).double().square().sum()) for g, w in zip(seen["grads"], want))
        norm = sum(float(w.double().square().sum()) for w in want)
        largest = max(float(w.norm()) for w in want)
        per = [float((g - w).norm() / w.norm()) for g, w in zip(seen["grads"], want)
               if float(w.norm()) >= 1e-3 * largest]
        out["f32"] = {"parts": got_parts, "parts_rel": parts_rel,
                      "grad_rel": (diff / norm) ** 0.5, "tensor_rel": max(per),
                      "tensors_held": len(per)}
        require(parts_rel <= DET_PARTS_RTOL, f"detnet float32 parts {got_parts} against the "
                f"per-replica oracle's {want_parts}")
        require(out["f32"]["grad_rel"] <= DET_GRAD_RTOL and max(per) <= DET_TENSOR_RTOL,
                f"detnet float32 gradient against the oracle: {out['f32']}")
        del oracle, preds, want, total
    del seen
    torch.cuda.empty_cache()
    return out


def _cpu_ring_rows(kp, vids, rank: int, size: int, rows: int):
    """The first ``rows`` queries of ``rank``'s shard mined on the CPU with
    the ring's padding, merging the database blocks in its rotation order
    (its own block, then the previous rank's, ...)."""
    import torch

    from simhand_tpu_torch.mining import similar_hands as S

    n, chunk = len(kp), MINE_CHUNK
    kp_t, vids_t = torch.from_numpy(kp), torch.from_numpy(vids)
    dpad = (-n) % (chunk * size)
    db = S._pad(kp_t, dpad, 0.0)
    dbv = S._pad(vids_t, dpad, S.PAD_DB_VIDEO)
    dbi = S._pad(torch.arange(n, dtype=torch.int32), dpad, -1)
    q_lo = rank * (n + (-n) % (chunk * size)) // size
    q = slice(q_lo, q_lo + rows)
    qi = torch.arange(q_lo, q_lo + rows, dtype=torch.int32)
    best = (torch.full((rows, 1), float("inf")), torch.full((rows, 1), -1, dtype=torch.int32))
    blk = db.shape[0] // size
    for r in range(size):
        b = slice(((rank - r) % size) * blk, ((rank - r) % size + 1) * blk)
        best = S._merge_block(kp_t[q], vids_t[q], qi, db[b], dbv[b], dbi[b], *best, 1, chunk)
    return q_lo, best[0].numpy(), best[1].numpy()


def _mining_arm(axis, seed: int) -> dict:
    """Sharded mining on this rank at phase 19's cell: both modes timed, the
    replicated database against phase 19's single-device result bit for
    bit, the ring's distances too and its first queries against the ring
    on the CPU; the tie corpus's ring on the card against the same ring on
    the CPU."""
    import numpy as np
    import torch

    from simhand_tpu_torch.mining import similar_hands as S

    rank = axis.index
    single = np.load(_mining_dir(seed) / "single.npz")
    rng = np.random.default_rng(seed)
    kp = rng.uniform(0, 1, size=(MINE_N, 21, 2)).astype(np.float32)
    vids = rng.integers(0, MINE_VIDEOS, size=MINE_N).astype(np.int32)
    kw = dict(k=1, query_chunk=MINE_CHUNK, db_chunk=MINE_CHUNK, mesh=axis)
    out = {}
    for mode in ("replicated", "ring"):
        axis.reduce_raw(torch.zeros(1, device="cuda"), "sum")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i = S.mine_similar_hands(kp, vids, shard_db=mode == "ring", **kw)
        secs = time.perf_counter() - t0
        out[mode] = {"s": secs, "hands_per_s": MINE_N / secs}
        require(same_bits(d, single["d"]), f"rank {rank} {mode}: distances differ from "
                "phase 19's single-device result")
        differ = int((i != single["i"]).sum())
        out[mode]["indices_differ"] = differ
        if mode == "replicated":
            require(differ == 0, f"rank {rank}: the replicated database's indices differ "
                    f"from one device's at {differ} queries")
        else:
            q_lo, cd, ci = _cpu_ring_rows(kp, vids, rank, axis.size, SH_CPU_QUERIES)
            rows = slice(q_lo, q_lo + SH_CPU_QUERIES)
            require(same_bits(d[rows], cd) and same_bits(i[rows], ci),
                    f"rank {rank}: the ring's queries {q_lo}.. differ from the CPU's ring")
    trng = np.random.default_rng(seed + 1)
    base = trng.integers(0, 4, size=(TIE_POSES, 21, 2)).astype(np.float32)
    tkp = base[trng.integers(0, TIE_POSES, size=TIE_N)]
    tvids = trng.integers(0, TIE_VIDEOS, size=TIE_N).astype(np.int32)
    tkw = dict(k=TIE_K, query_chunk=TIE_QUERY_CHUNK, db_chunk=TIE_DB_CHUNK, mesh=axis,
               shard_db=True)
    got = S.mine_similar_hands(tkp, tvids, **tkw)
    want = S.mine_similar_hands(tkp, tvids, device="cpu", **tkw)
    require(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
            f"rank {rank}: the tie corpus's ring on the card differs from the CPU's")
    one = S.mine_similar_hands(tkp, tvids, device="cpu", k=TIE_K,
                               query_chunk=TIE_QUERY_CHUNK, db_chunk=TIE_DB_CHUNK)
    out["tie_ring_indices_differ_from_one_device"] = int((got[1] != one[1]).sum())
    return out


def _sharded_rank(seed: int, rank: int, port: int) -> dict:
    """One of SH_WORLD ranks on the one card (phase 21)."""
    import datetime

    import torch.distributed as dist

    from simhand_tpu_torch.parallel import create_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=SH_WORLD,
                            timeout=datetime.timedelta(seconds=SH_DEADLINE_S))
    axis = create_mesh()
    out = {"rank": rank}
    t0 = time.perf_counter()
    out["fsdp"] = _fsdp_arm(axis, seed)
    t1 = time.perf_counter()
    out["fsdp_fused"] = _fsdp_fused_arm(axis, seed)
    t2 = time.perf_counter()
    out["detnet"] = _detnet_arm(axis, seed)
    t3 = time.perf_counter()
    out["mining"] = _mining_arm(axis, seed)
    out["arm_s"] = {"fsdp": t1 - t0, "fsdp_fused": t2 - t1, "detnet": t3 - t2,
                    "mining": time.perf_counter() - t3}
    out["staged"] = sorted(axis.staged)
    dist.destroy_process_group()
    return out


def _sharded_world1(seed: int, port: int) -> dict:
    """The NCCL group at world size 1: the FSDP step against the
    single-device step, bit for bit (one rank shards nothing and has no
    axis), with the exact BatchNorm and with each mode of FSDP_FUSED."""
    import datetime

    import torch
    import torch.distributed as dist

    from simhand_tpu_torch.parallel import create_mesh, make_fsdp_train_step
    from simhand_tpu_torch.train import make_train_step

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=SH_DEADLINE_S),
                            device_id=torch.device("cuda", 0))
    axis = create_mesh()
    cfg, batch = step_config(), synthetic_batch(seed)
    out = {}
    for bn_fused in (False, *FSDP_FUSED):
        single, fsdp = new_state(seed, bn_fused=bn_fused), new_state(seed, bn_fused=bn_fused)
        single_step = make_train_step(single.model, cfg)
        fsdp_step, place_state, place_batch = make_fsdp_train_step(fsdp.model, cfg, axis, fsdp)
        fsdp, local = place_state(fsdp), place_batch(batch)
        losses = {"single": [], "fsdp": []}
        for _ in range(SH_W1_STEPS):
            single, m = single_step(single, batch)
            losses["single"].append(float(m["contrastive_loss"]))
            fsdp, m = fsdp_step(fsdp, local)
            losses["fsdp"].append(float(m["contrastive_loss"]))
        want, got = single.payload(), fsdp.payload()
        differ = [k for k in want["model"] if not torch.equal(want["model"][k], got["model"][k])]
        differ += [f"mu{j}" for j, (a, b) in enumerate(zip(want["optimizer"]["mu"],
                                                           got["optimizer"]["mu"]))
                   if not torch.equal(a, b)]
        require(losses["single"] == losses["fsdp"],
                f"NCCL world 1 FSDP (bn_fused={bn_fused}) losses {losses}")
        require(not differ, f"NCCL world 1 FSDP (bn_fused={bn_fused}): {len(differ)} tensors "
                f"differ, e.g. {differ[:3]}")
        out[str(bn_fused)] = {"losses": losses["fsdp"],
                              "tensors_equal": len(want["model"]) + len(want["optimizer"]["mu"])}
        del single, fsdp, single_step, fsdp_step, want, got
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return out


def sharded_phase(seed: int) -> tuple[dict, dict]:
    """Phase 21: the NCCL world-1 process, then the SH_WORLD gloo ranks.
    Returns the phase's record and the launches a rank a step of #2/#4
    (FSDP) and #9 (the detnet step)."""
    import pathlib

    t0 = time.perf_counter()
    work = pathlib.Path(__file__).resolve().parent / "build" / f"sharded_{seed}"
    work.mkdir(parents=True, exist_ok=True)
    deadline = time.monotonic() + SH_DEADLINE_S
    common = ["--seed", str(seed)]
    _run_children([["--dp-role", "sharded_world1", "--dp-port", str(_free_port()),
                    "--dp-out", str(work / "world1.json"), *common]], deadline)
    world1 = json.loads((work / "world1.json").read_text())
    w1_s = time.perf_counter() - t0
    for mode, w in world1.items():
        print(f"NCCL world 1, bn_fused={mode}: the FSDP step == the single-device step bit for "
              f"bit over {SH_W1_STEPS} steps (losses {w['losses']}, {w['tensors_equal']} "
              f"tensors and moments)")
    print(f"NCCL world 1: {w1_s:.1f} s")
    t1 = time.perf_counter()
    port = _free_port()
    logs = _run_children([["--dp-role", "sharded_rank", "--dp-rank", str(r), "--dp-port",
                           str(port), "--dp-out", str(work / f"rank{r}.json"), *common]
                          for r in range(SH_WORLD)], deadline)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(SH_WORLD)]
    ranks_s = time.perf_counter() - t1
    r0 = ranks[0]
    f = r0["fsdp"]
    print(f"FSDP on {SH_WORLD} ranks of one card (ResNet-50, {SIDE}x{SIDE}, bf16, B = {PAIRS} "
          f"pairs): losses {f['losses']}, step 0 rel {f['loss0_rel']:.2e} to one process's "
          f"{f['single_loss0']:.7f}; launches a rank {[r['fsdp']['launches'] for r in ranks]}")
    print(f"FSDP state held a rank: {[r['fsdp']['held_bytes'] / 1e6 for r in ranks]} MB of the "
          f"replicated {f['whole_bytes'] / 1e6:.1f} MB; {f['step_ms']:.2f} ms/step (two "
          f"processes sharing one card, no scaling claim); gather {f['gather_ms']:.2f} ms and "
          f"reduce-scatter {f['reduce_scatter_ms']:.2f} ms of the {f['split_mb']:.1f} MB of "
          f"split leaves over gloo; #10 under FSDP {f['conv1x1']}")
    print(f"FSDP float32 against one process: {f['f32']}")
    for mode, g in r0["fsdp_fused"].items():
        print(f"FSDP bn_fused={mode!r} on {SH_WORLD} ranks: losses {g['losses']}; launches a "
              f"rank a step {[r['fsdp_fused'][mode]['launches'] for r in ranks]}, worst sums "
              f"rel {max(r['fsdp_fused'][mode]['sums_rel'] for r in ranks):.2e} to their plain "
              f"versions over {g['reduces']} reduces a step; {g['step_ms']:.2f} ms/step, of it "
              f"the {g['bn_allreduces']} BatchNorm all-reduces alone {g['bn_allreduce_ms']:.2f} "
              f"ms ({100 * g['bn_allreduce_share']:.1f}%); float32 against one process "
              f"{g['f32']}")
    d = r0["detnet"]
    print(f"data-parallel detnet (ResNet-50, 128x128, bf16, {DET_BATCH} images, fused_pallas): "
          f"det_total {d['det_total']}; #9 {[r['detnet']['launches'] for r in ranks]} launches "
          f"a rank in {DET_STEPS} steps, worst sums rel "
          f"{max(r['detnet']['sums_rel'] for r in ranks):.2e}; {d['step_ms']:.2f} ms/step; "
          f"float32 against the per-replica oracle {d['f32']}")
    m = r0["mining"]
    print(f"sharded mining {MINE_N} hands on {SH_WORLD} ranks of one card: replicated "
          f"{m['replicated']['s']:.2f} s ({m['replicated']['hands_per_s']:.1f} hands/s), == one "
          f"device bit for bit; ring {m['ring']['s']:.2f} s ({m['ring']['hands_per_s']:.1f} "
          f"hands/s), distances == one device's, {m['ring']['indices_differ']} indices settled "
          f"otherwise by the rotation, the first {SH_CPU_QUERIES} queries of each rank == the "
          f"ring on the CPU; tie corpus ring card == CPU "
          f"({m['tie_ring_indices_differ_from_one_device']} indices differ from one device's)")
    staged = sorted({s for r in ranks for s in r["staged"]})
    phase_s = time.perf_counter() - t0
    print(f"gloo staged through the host: {staged}; arms a rank {r0['arm_s']}")
    print(f"phase 21 (FSDP, data-parallel detnet, sharded mining): {phase_s:.1f} s, of it the "
          f"two ranks {ranks_s:.1f} s")
    launches = {**{k: n // FSDP_STEPS for k, n in f["launches"].items()},
                "conv1x1_stats": f["conv1x1"]["launches"]["conv1x1_stats"],
                "bn_backward_reduces": d["launches"] // DET_STEPS,
                "fsdp_bn": {k: n for g in r0["fsdp_fused"].values()
                            for k, n in g["launches"].items() if n}}
    perf = {"world1": world1, "ranks": ranks, "phase_s": phase_s, "ranks_s": ranks_s,
            "staged": staged, "rank_logs_tail": [log[-2000:] for log in logs]}
    return perf, launches


# phase 22, the MANO side, after phase 21: MANO at its real widths on
# synthetic parameters from --seed (the official MANO_RIGHT.pkl is not in
# the repo), ShapeNet at its real widths, the demo's detnet as phase 18's
# bf16 artifact. No kernel of the record lies on this path.
# the MANO forward on the card against the CPU, relative to the largest
# output (float32, TF32 off; the two differ by the sums' order)
MANO_BATCHES, MANO_TIMED, MANO_RTOL = (1, 4096), 20, 1e-5
# create_data at its default --total; the first SIK1M_CHECKED rows' bones
# against relative_bone_lengths on the CPU, element by element
SIK1M_TOTAL, SIK1M_CHECKED, SIK1M_RTOL = 1_000_000, 4096, 1e-6
# train_shape_net on each route (its default is 5,000 steps); the loss's
# mean over the last SHAPE_WINDOW steps must be below the first's
SHAPE_STEPS, SHAPE_BATCH, SHAPE_WINDOW = 1000, 512, 100
# optimize_shape: the synthetic comparison's targets and the predicted
# joints of the dl route; PSO's first beta on the card against the CPU
OPT_N, PRE_JOINTS, PSO_ATOL = 32, 256, 1e-4
RECON_N, DEMO_FRAMES, DEMO_VERTS_RTOL = 8, 64, 1e-5


def synthetic_mano_params(seed: int) -> dict:
    """MANO's widths (778 vertices, 16 joints, 10 shape and 135 pose
    coefficients) with random but kinematically sane values: a copy of
    tests/test_mano.py's generator (the CPU tests hold the two equal)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_v = 778
    # skeleton: wrist at origin, 15 joints spread forward
    joints = np.zeros((16, 3))
    parents = np.array([0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14])
    for j in range(1, 16):
        joints[j] = joints[parents[j]] + rng.uniform(0.02, 0.04, 3)
    # vertices clustered around joints
    assign = rng.integers(0, 16, n_v)
    verts = joints[assign] + rng.normal(scale=0.01, size=(n_v, 3))
    # regressor: averages the verts assigned to each joint
    j_reg = np.zeros((16, n_v))
    for j in range(16):
        members = np.where(assign == j)[0]
        j_reg[j, members] = 1.0 / len(members)
    weights = np.zeros((n_v, 16), np.float32)
    weights[np.arange(n_v), assign] = 1.0
    kintree = np.zeros((2, 16), np.int64)
    kintree[0] = parents
    return {
        "v_template": verts.astype(np.float32),
        "shapedirs": rng.normal(scale=0.001, size=(n_v, 3, 10)).astype(np.float32),
        "posedirs": rng.normal(scale=0.0001, size=(n_v, 3, 135)).astype(np.float32),
        "J_regressor": j_reg.astype(np.float32),
        "weights": weights,
        "kintree_table": kintree,
    }


def random_poses(rng, b: int, scale: float):
    """(b, 16, 3, 3) float32 rotations of axis-angles ~ N(0, scale^2) a
    component, through the port's Rodrigues (``finetune.aik.axangle2mat``)."""
    import numpy as np

    from simhand_tpu_torch.finetune.aik import axangle2mat

    aa = rng.normal(scale=scale, size=(b, 16, 3))
    return np.stack([[axangle2mat(v, np.linalg.norm(v)) for v in row]
                     for row in aa]).astype(np.float32)


def rel_largest(got, want) -> float:
    """max |got - want| over max |want|, of two tensors or arrays."""
    import torch

    got, want = torch.as_tensor(got), torch.as_tensor(want)
    return float((got - want).abs().max() / want.abs().max())


def level_chain_mano(*args, **kwargs):
    """A ManoModel whose kinematic chain runs one batched product a level of
    the tree (three for MANO) in place of the port's product a joint: the
    design phase 22 times against the port's."""
    import numpy as np
    import torch

    from simhand_tpu_torch.finetune.mano import ManoModel

    class LevelChainMano(ManoModel):
        def __init__(self):
            super().__init__(*args, **kwargs)
            depth = np.zeros(len(self.parents), np.int64)
            for j in range(1, len(self.parents)):
                depth[j] = depth[self.parents[j]] + 1
            self.level_index = [
                tuple(torch.as_tensor(ix.astype(np.int64), device=self.device)
                      for ix in (np.flatnonzero(depth == d), self.parents[depth == d]))
                for d in range(1, int(depth.max()) + 1)]

        def _kinematic_chain(self, local):
            A = local.clone()
            for joints, parents in self.level_index:
                A[:, joints] = A[:, parents] @ local[:, joints]
            return A

    return LevelChainMano()


class StageClock:
    """Seconds by stage of the demo's per-frame function: each wrapped call
    is bracketed by two synchronizations."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)

    def wrap(self, name: str, fn):
        import torch

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            return out

        return run


def demo_route(mano, mano_cpu, apply, shape_net, frames, route: str) -> dict:
    """The demo's per-frame function on ``frames``: once plain (frames/s),
    once with each stage timed; then each frame's reconstruct on the CPU
    from the card's xyz and beta against the card's verts."""
    import numpy as np

    from simhand_tpu_torch.finetune import demo, recon

    def fresh():
        return demo.DemoState(apply=apply, mano=mano, shape_net=shape_net)

    state = fresh()
    demo.track_frame(state, frames[0])        # the artifact's first call
    state = fresh()
    t0 = time.perf_counter()
    outs = [demo.track_frame(state, f) for f in frames]
    wall = time.perf_counter() - t0
    for xyz, uv, verts, beta in outs:
        require(xyz.shape == (21, 3) and uv.shape == (21, 2) and verts.shape == (778, 3)
                and beta.shape == (10,), f"demo ({route}): shapes {xyz.shape} {verts.shape}")
        require(all(np.isfinite(a).all() for a in (xyz, uv, verts, beta)),
                f"demo ({route}): a non-finite output")
    errs = [rel_largest(verts, recon.reconstruct(mano_cpu, xyz, beta=beta)[0])
            for xyz, _, verts, beta in outs]
    print(f"demo ({route}): {len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.1f} "
          f"frames/s; verts against reconstruct on the CPU, worst {max(errs):.2e} "
          f"[limit {DEMO_VERTS_RTOL:.0e}]")
    require(max(errs) <= DEMO_VERTS_RTOL,
            f"demo ({route}): the card's verts are off reconstruct on the CPU: {max(errs):.2e}")

    clock, state = StageClock(), fresh()
    state.apply = clock.wrap("forward", apply)
    state.smoother.process = clock.wrap("smoother", state.smoother.process)
    mano.forward = clock.wrap("mano", mano.forward)
    saved = {"regress_shape": demo.regress_shape, "pso_fit_shape": recon.pso_fit_shape,
             "adaptive_ik": recon.adaptive_ik}
    demo.regress_shape = clock.wrap("shape", demo.regress_shape)
    recon.pso_fit_shape = clock.wrap("shape", recon.pso_fit_shape)
    recon.adaptive_ik = clock.wrap("aik", recon.adaptive_ik)
    try:
        t0 = time.perf_counter()
        for f in frames:
            demo.track_frame(state, f)
        split_wall = time.perf_counter() - t0
    finally:
        del mano.forward
        demo.regress_shape = saved["regress_shape"]
        recon.pso_fit_shape, recon.adaptive_ik = saved["pso_fit_shape"], saved["adaptive_ik"]
    ms = {k: 1e3 * v / len(frames) for k, v in clock.seconds.items()}
    ms["rest"] = 1e3 * split_wall / len(frames) - sum(ms.values())
    print(f"demo ({route}) ms a frame, each stage synchronized: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    return {"frames_per_s": len(frames) / wall, "wall_s": wall, "ms_a_frame": ms,
            "verts_vs_cpu": max(errs)}


def mano_side_phase(seed: int) -> dict:
    """Phase 22: the MANO side's entry points on the card, at MANO's and
    ShapeNet's real widths, under build/mano_<seed>."""
    import pickle
    import shutil

    import numpy as np
    import torch

    from simhand_tpu_torch import native
    from simhand_tpu_torch.core.joints import JointMap
    from simhand_tpu_torch.finetune import create_data, optimize_shape, recon, train_shape_net
    from simhand_tpu_torch.finetune.mano import ManoModel, relative_bone_lengths
    from simhand_tpu_torch.finetune.shape_net import load_shape_net, pso_fit_shape
    from simhand_tpu_torch.serving import export
    from simhand_tpu_torch.train.checkpoint import export_state_dict

    t_phase = time.perf_counter()
    launches_before = counted_launches()
    root = native.BUILD_DIR / f"mano_{seed}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    pkl = str(root / "mano_synthetic.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(synthetic_mano_params(seed), f)
    mano, mano_cpu = ManoModel(pkl), ManoModel(pkl, device="cpu")
    require(mano.device.type == "cuda", f"ManoModel built on {mano.device}")
    perf = {"mano": {}}
    rng = np.random.default_rng(seed)

    mano_levels = level_chain_mano(pkl)
    for b in MANO_BATCHES:
        pose = torch.from_numpy(random_poses(rng, b, 0.5))
        beta = torch.from_numpy((2.0 * rng.standard_normal((b, 10))).astype(np.float32))
        pose_c, beta_c = pose.cuda(), beta.cuda()
        with torch.no_grad():
            got = [t.cpu() for t in mano(pose_c, beta_c)]
            want = mano_cpu(pose, beta)
            err = max(rel_largest(g, w) for g, w in zip(got, want))
            lv_err = max(rel_largest(g.cpu(), w)
                         for g, w in zip(mano_levels(pose_c, beta_c), want))
            ms = cuda_ms(lambda: mano(pose_c, beta_c), MANO_TIMED)
            lv_ms = cuda_ms(lambda: mano_levels(pose_c, beta_c), MANO_TIMED)
            ms_again = cuda_ms(lambda: mano(pose_c, beta_c), MANO_TIMED)
        perf["mano"][f"b{b}"] = {"rel_err": err, "ms": ms, "ms_again": ms_again,
                                 "level_chain_ms": lv_ms, "level_chain_rel_err": lv_err}
        print(f"MANO forward B = {b}: {ms:.4f} ms a forward (again after the level chain "
              f"{ms_again:.4f}); the chain a level at a time {lv_ms:.4f} ms; verts and "
              f"joints21 against the CPU {err:.2e} of the largest, the level chain's "
              f"{lv_err:.2e} [limit {MANO_RTOL:.0e}]")
        require(max(err, lv_err) <= MANO_RTOL,
                f"the MANO forward at B = {b} is off the CPU's: {err:.2e} / {lv_err:.2e}")
    del pose_c, beta_c, mano_levels

    sik = str(root / "sik1m")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    create_data.main(["--mano", pkl, "--out", sik, "--seed", str(seed)])
    secs = time.perf_counter() - t0
    bones, shapes = np.load(f"{sik}/data_bone.npy"), np.load(f"{sik}/data_shape.npy")
    require(bones.shape == (SIK1M_TOTAL, 15) and shapes.shape == (SIK1M_TOTAL, 10),
            f"create_data wrote {bones.shape} / {shapes.shape}")
    with torch.no_grad():
        want = relative_bone_lengths(
            mano_cpu, torch.from_numpy(shapes[:SIK1M_CHECKED].astype(np.float32))).numpy()
    err = float(np.max(np.abs(bones[:SIK1M_CHECKED] - want) / np.abs(want)))
    perf["create_data"] = {"seconds": secs, "samples_per_s": SIK1M_TOTAL / secs,
                           "bones_rel_err": err}
    print(f"create_data --total {SIK1M_TOTAL}: {secs:.2f} s = {SIK1M_TOTAL / secs:.0f} "
          f"samples/s (files written); the first {SIK1M_CHECKED} bones against the CPU: rel "
          f"{err:.2e} [limit {SIK1M_RTOL:.0e}]")
    require(np.isfinite(bones).all() and err <= SIK1M_RTOL,
            f"create_data's bones are off relative_bone_lengths on the CPU: {err:.2e}")
    del bones, shapes

    perf["train_shape_net"] = {}
    for route, extra in (("data_root", ["--data_root", sik]), ("on_the_fly", [])):
        out = str(root / f"shape_net_{route}.pt")
        flags = ["--mano", pkl, "--batch_size", str(SHAPE_BATCH), "--seed", str(seed), *extra]
        # set-up alone (MANO, ShapeNet's init, SIK1M's load), to take out of
        # the whole call's time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_shape_net.main([*flags, "--steps", "0"])
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        model, losses = train_shape_net.main([*flags, "--steps", str(SHAPE_STEPS), "--out", out])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        step_ms = 1e3 * (secs - setup) / SHAPE_STEPS
        first, last = float(losses[:SHAPE_WINDOW].mean()), float(losses[-SHAPE_WINDOW:].mean())
        loaded = load_shape_net(out, "cuda")
        same = all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                      model.state_dict().values()))
        perf["train_shape_net"][route] = {"ms_a_step": step_ms, "seconds": secs,
                                          "setup_s": setup, "first_mean": first,
                                          "last_mean": last}
        print(f"train_shape_net ({route}, B = {SHAPE_BATCH}, {SHAPE_STEPS} steps): "
              f"{step_ms:.3f} ms a step (the call's {secs:.3f} s less a --steps 0 call's "
              f"{setup:.3f} s of set-up); loss mean of the first {SHAPE_WINDOW} steps "
              f"{first:.6f}, of the last {last:.6f}; --out loads strict and equal: {same}")
        require(np.isfinite(losses).all() and len(losses) == SHAPE_STEPS,
                f"train_shape_net ({route}): non-finite losses")
        require(last < first, f"train_shape_net ({route}): the loss did not fall")
        require(same, f"train_shape_net ({route}): --out differs from the trained model")
    shape_net_file = str(root / "shape_net_on_the_fly.pt")

    t0 = time.perf_counter()
    out = optimize_shape.main(["--mano", pkl, "--n", str(OPT_N), "--shapenet", shape_net_file,
                               "--seed", str(seed)])
    secs = time.perf_counter() - t0
    cpu_beta = pso_fit_shape(mano_cpu, out["targets"][0], n_particles=80, n_iters=25, seed=0)
    pso_err = float(np.abs(out["pso_beta"][0] - cpu_beta).max())
    maes = {k: float(out[k]) for k in ("pso_mae", "lm_mae", "shapenet_mae")}
    perf["optimize_shape"] = {"synthetic_s": secs, **maes, "pso_card_vs_cpu": pso_err}
    print(f"optimize_shape --n {OPT_N}: {secs:.2f} s; bone-length MAE {maes}; PSO's first "
          f"beta on the card against the CPU {pso_err:.2e} [limit {PSO_ATOL:.0e}]")
    require(all(math.isfinite(v) for v in maes.values()), f"optimize_shape: MAE {maes}")
    require(pso_err <= PSO_ATOL, f"PSO on the card is off the CPU's: {pso_err:.2e}")

    pose = torch.from_numpy(random_poses(rng, PRE_JOINTS, 0.4)).cuda()
    beta = torch.from_numpy((2.0 * rng.standard_normal((PRE_JOINTS, 10))).astype(np.float32))
    with torch.no_grad():
        _, j21 = mano(pose, beta.cuda())
    joints_file, beta_file = str(root / "pre_joints.npy"), str(root / "dl_beta.npy")
    np.save(joints_file, JointMap().mano_to_freihand(j21.cpu().numpy()))
    t0 = time.perf_counter()
    out = optimize_shape.main(["--mano", pkl, "--shapenet", shape_net_file,
                               "--pre_joints", joints_file, "--out_beta", beta_file])
    secs = time.perf_counter() - t0
    saved = np.load(beta_file)
    perf["optimize_shape"].update(dl_s=secs, dl_error_sum=float(out["per_bone"].sum()))
    require(saved.shape == (PRE_JOINTS, 10) and np.isfinite(saved).all()
            and np.isfinite(out["per_bone"]).all(), "optimize_shape --pre_joints: non-finite")

    t0 = time.perf_counter()
    metrics = recon.main(["--mano", pkl, "--n", str(RECON_N)])
    perf["recon"] = {"seconds": time.perf_counter() - t0,
                     **{k: float(v) for k, v in metrics.items()}}
    require(all(math.isfinite(v) for v in perf["recon"].values()), f"recon: {metrics}")

    serving = native.BUILD_DIR / f"serving_{seed}"
    artifact = serving / "detnet_bf16.pt2"
    if not artifact.exists():
        serving.mkdir(parents=True, exist_ok=True)
        export_state_dict(serving_detnet(seed), str(serving / "detnet.pth"))
        export.main(["--surface", "detnet", "--backbone", RESNET, "--side", str(SIDE),
                     "--pth", str(serving / "detnet.pth"), "--out", str(artifact)])
        print(f"demo: exported {artifact} (phase 18's artifact was absent)")
    apply, meta = export.load_artifact(str(artifact))
    require(meta["surface"] == "detnet" and meta["side"] == SIDE, f"artifact header {meta}")
    frames = rng.uniform(-0.5, 0.5, (DEMO_FRAMES, SIDE, SIDE, 3)).astype(np.float32)
    perf["demo"] = {
        "pso": demo_route(mano, mano_cpu, apply, None, frames, "pso"),
        "shape_net": demo_route(mano, mano_cpu, apply, load_shape_net(shape_net_file, "cuda"),
                                frames, "shape_net")}

    launches = {"+".join(k): n - launches_before[k] for k, n in counted_launches().items()}
    perf["kernel_launches"] = launches
    require(not any(launches.values()), f"a kernel of the record launched in phase 22: {launches}")
    perf["seconds"] = time.perf_counter() - t_phase
    print(f"phase 22 (the MANO side): {perf['seconds']:.1f} s; kernel launches {launches}")
    return perf


# phase 23, the workflow checks, after phase 22. A: the grand loop at full
# width, its pre-training GL_STEPS (two epochs of CACHE_IMAGES // PAIRS
# batches) and its fine-tune GL_FT_STEPS at phase 17's batch. B: the eight
# experiment types on phase 3's cache, PLAIN_STEPS steps each, and the entry
# point for ENTRY_TYPE_STEPS steps of each type no earlier phase runs. C: the
# transfer miniature at scripts/transfer_check.py's batch and the cells of
# SCALING.md:362-373 (bn_grid.py at corpus seed 0) and ROUND3.md:91,119: label,
# backbone, pre-training and fine-tune steps, the pretrained arms as
# (experiment type, bn_variant), and the arms whose lossH must end below
# TRANSFER_MARGIN x the random arm's (a cell with none runs no random arm)
GL_STEPS, GL_FT_STEPS = 2 * (CACHE_IMAGES // PAIRS), 8
GL_PRETRAIN_FLAGS = ("--weight_type", "linear", "--diff_type", "mpjpe", "--pos_neg", "pos_neg",
                     "--joints_type", "original", "--color_jitter", "--use_pallas",
                     "--bn_variant", "stop_grad")
ENTRY_TYPES = ("simclr", "simclr_w", "peclr", "peclr_w", "simhand", "simhand_vis")
ENTRY_TYPE_STEPS = 2
TRANSFER_BATCH, TRANSFER_MARGIN = 16, 0.98
TRANSFER_CELLS = (
    ("rn18_120_60", "18", 120, 60,
     {"exact": ("simhand_w", "exact"), "stop_grad": ("simhand_w", "stop_grad")}, ("stop_grad",)),
    ("rn18_60_60", "18", 60, 60,
     {"simhand_w": ("simhand_w", "exact"), "simclr": ("simclr", "exact")}, ()),
    ("rn50_60_60", "50", 60, 60,
     {"exact": ("simhand_w", "exact"), "stop_grad": ("simhand_w", "stop_grad")},
     ("exact", "stop_grad")),
)
# the reference's lossH_final at the same cells: XLA-CPU on the JPEG route
# of the JAX script (its corpus's frames cropped with cv2): SCALING.md:366-372
# (round 5, a one-core host) and the rn18 60/60 pair ROUND3.md:91,119 (round
# 3, a multi-core host, whose random arm read 0.406)
TRANSFER_REFERENCE = {"rn18_120_60": {"random": 0.3945, "exact": 0.4656, "stop_grad": 0.2878},
                      "rn18_60_60": {"simhand_w": 0.323, "simclr": 0.432},
                      "rn50_60_60": {"random": 0.4136, "exact": 0.2882, "stop_grad": 0.2795}}


def launch_counting(make, kernels, log: list):
    """``make`` wrapped: each step it makes appends (the launches of
    ``kernels`` in that step by name, its metrics as floats) to ``log``."""
    def wrapped(*a, **k):
        step = make(*a, **k)

        def run(state, batch):
            before = {fn.__name__: fn.launches for fn in kernels}
            state, metrics = step(state, batch)
            log.append(({fn.__name__: fn.launches - before[fn.__name__] for fn in kernels},
                        {name: float(v) for name, v in metrics.items()}))
            return state, metrics

        return run

    return wrapped


def grand_loop_part(seed: int, base) -> dict:
    """Part A of phase 23: ``run_grand_loop`` at full width with its checks,
    then a random-init fine-tune at the same budget."""
    import torch

    from simhand_tpu_torch import transfer_check as T
    from simhand_tpu_torch.experiments import main as entry
    from simhand_tpu_torch.finetune import train as ft
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import fused_bn as FB

    pre_log, ft_log, landed = [], [], []
    real_make, real_ft_make = entry.make_train_step, ft.make_detnet_train_step
    workdir = base / "grand_loop"
    export = workdir / "encoder_pretrained.pth"

    def landing_make(model, *a, **k):
        # the export, bit for bit, in the detnet before its first step
        sd = torch.load(export, weights_only=True)
        enc = {name: v for name, v in model.encoder.resnet.state_dict().items()
               if not name.endswith("num_batches_tracked")}
        landed.append(sd.keys() == enc.keys()
                      and all(torch.equal(sd[name], enc[name].cpu()) for name in sd))
        return launch_counting(real_ft_make, FB.KERNELS, ft_log)(model, *a, **k)

    entry.make_train_step = launch_counting(real_make, K.KERNELS, pre_log)
    ft.make_detnet_train_step = landing_make
    try:
        record = T.run_grand_loop(
            str(workdir), images=CACHE_IMAGES, batch_size=PAIRS, resnet_size=RESNET,
            pretrain_steps=GL_STEPS, finetune_steps=GL_FT_STEPS,
            extra_pretrain_args=(*GL_PRETRAIN_FLAGS, "-seed", str(seed)), device="cuda",
            finetune_batch_size=FT_BATCH, extra_finetune_args=("--bn_variant", "fused_pallas"),
            seed=seed)
    finally:
        entry.make_train_step, ft.make_detnet_train_step = real_make, real_ft_make
    mining = record["mining"]
    mismatch = int((mining["positives"] != mining["oracle"]).sum())
    seconds = {name: r["seconds"] for name, r in record.items()}
    print(f"grand loop: stage seconds {seconds}; mined top-1 against top1_cross_video: "
          f"{mismatch} of {CACHE_IMAGES} differ")
    pre_losses = [m["contrastive_loss"] for _, m in pre_log]
    print(f"grand loop pre-training ({record['pretrain']['step']} steps): losses {pre_losses}; "
          f"launches a step {[n for n, _ in pre_log]}")
    ft_parts = [m for _, m in ft_log]
    print(f"grand loop fine-tune: det_total {[p['det_total'] for p in ft_parts]}; #9 a step "
          f"{[n['bn_backward_reduces'] for n, _ in ft_log]}; export landed {landed}; metrics "
          f"{ {k: v for k, v in record['finetune'].items() if k != 'out_dir'} }")
    print(f"grand loop evaluate: {record['evaluate']}")
    require(mismatch == 0, f"the mined positives differ from the oracle at {mismatch} hands")
    require(len(pre_log) == GL_STEPS and all(math.isfinite(v) for v in pre_losses),
            f"grand loop pre-training: {len(pre_log)} steps, losses {pre_losses}")
    require(all(n["weighted_ntxent_denominator"] == 1 and n["weighted_grad_rows"] == 1
                and n["ntxent_denominator"] == n["ntxent_grad"] == 0 for n, _ in pre_log),
            f"#2/#4 not launched once on every pre-training step: {[n for n, _ in pre_log]}")
    require(landed == [True], f"the export did not land bit for bit in the detnet: {landed}")
    require(len(ft_log) == GL_FT_STEPS
            and all(math.isfinite(v) for p in ft_parts for v in p.values()),
            f"grand loop fine-tune: {len(ft_log)} steps, parts {ft_parts}")
    require(all(n["bn_backward_reduces"] == FUSED_BN_PER_STEP for n, _ in ft_log),
            f"#9 not launched {FUSED_BN_PER_STEP} times on every fine-tune step: "
            f"{[n for n, _ in ft_log]}")
    require(all(math.isfinite(v) for v in record["evaluate"].values() if isinstance(v, float)),
            f"non-finite evaluation {record['evaluate']}")

    # a random-init fine-tune at the same budget, printed beside the pretrained one
    t0 = time.perf_counter()
    random_dir = str(base / "grand_loop_random")
    ft.main(T.finetune_argv(random_dir, GL_FT_STEPS, FT_BATCH, resnet_size=RESNET)
            + ["--bn_variant", "fused_pallas"], device="cuda")
    random_metrics = T.read_metrics(random_dir)
    random_s = time.perf_counter() - t0
    print(f"grand loop: fine-tune from the export {record['finetune']['lossH_final']:.4f} "
          f"lossH against {random_metrics['lossH_final']:.4f} from a random init at the same "
          f"budget ({GL_FT_STEPS} steps; {random_s:.1f} s)")
    return {"seconds": seconds, "mined_mismatch": mismatch, "pretrain_losses": pre_losses,
            "pretrain_launches": [n for n, _ in pre_log],
            "finetune_det_total": [p["det_total"] for p in ft_parts],
            "finetune_launches": [n["bn_backward_reduces"] for n, _ in ft_log],
            "finetune": {k: v for k, v in record["finetune"].items() if k != "out_dir"},
            "evaluate": record["evaluate"], "random_init": random_metrics,
            "random_init_s": random_s}


def experiment_types_part(seed: int, base) -> dict:
    """Part B of phase 23: the eight experiment types on the kernel route
    at full width, step 0 against the dense route and PLAIN_STEPS steps
    each on one batch of phase 3's cache augmented on the card; then the
    entry point for ENTRY_TYPE_STEPS steps of each of ENTRY_TYPES."""
    import torch

    from simhand_tpu_torch import native
    from simhand_tpu_torch.data import augment as A
    from simhand_tpu_torch.data.cache import CachedHand100MSource
    from simhand_tpu_torch.data.pipeline import PretrainDataset, batch_iterator
    from simhand_tpu_torch.experiments import main as entry
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models.contrastive import _WEIGHTED, EXPERIMENT_TYPES
    from simhand_tpu_torch.train import make_train_step

    def kernels_of(etype: str) -> tuple[str, str]:
        return (("weighted_ntxent_denominator", "weighted_grad_rows") if etype in _WEIGHTED
                else ("ntxent_denominator", "ntxent_grad"))

    def once_a_step(etype: str, launches: dict) -> bool:
        return all(n == (name in kernels_of(etype)) for name, n in launches.items())

    cache = native.BUILD_DIR / f"cache_fed_{seed}"
    source = CachedHand100MSource(str(cache))
    flags, params = augment_flag_sets()["main"], A.AugmentParams()
    state = new_state(seed)
    out = {"types": {}, "entry_point": {}}
    t0 = time.perf_counter()
    for etype in EXPERIMENT_TYPES:
        batches = batch_iterator(PretrainDataset(source, etype, flags, params), PAIRS,
                                 seed=seed, raw=True)
        try:
            raw = {k: torch.from_numpy(v).cuda() for k, v in next(batches).items()}
        finally:
            batches.close()
        views = A.prepare_views(raw, A.seeded_generator("cuda", seed), flags, params, SIDE)
        cfg = step_config(experiment_type=etype)
        compare_routes(state, views, cfg, f"{etype} step 0")
        log = []
        step = launch_counting(make_train_step, K.KERNELS, log)(state.model, cfg)
        state, losses = run_steps(step, state, views, etype, steps=PLAIN_STEPS)
        require(all(once_a_step(etype, n) for n, _ in log),
                f"{etype}: the NT-Xent launches a step {[n for n, _ in log]}, not one each "
                f"of {kernels_of(etype)}")
        out["types"][etype] = {"losses": losses, "launches": [n for n, _ in log]}
        print(f"experiment type {etype}: losses {losses}; launches a step "
              f"{[n for n, _ in log]}")
    del state
    out["types_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    real_make = entry.make_train_step
    try:
        for etype in ENTRY_TYPES:
            log = []
            entry.make_train_step = launch_counting(real_make, K.KERNELS, log)
            argv = ["--experiment_type", etype, "--crop", "--resize", "--rotate",
                    "-sources", "synthetic", "--cache_dir", str(cache), "--device_augment",
                    "--use_pallas", "-batch_size", str(PAIRS), "-resnet_size", RESNET,
                    "-epochs", "1", "--max_steps", str(ENTRY_TYPE_STEPS),
                    "-log_interval", "step", "-experiment_name", f"types_{etype}",
                    "-seed", str(seed)]
            if etype in _WEIGHTED:
                argv += ["--weight_type", "linear", "--diff_type", "mpjpe",
                         "--pos_neg", "pos_neg"]
            entry.main(argv, device="cuda")
            losses = [m["contrastive_loss"] for _, m in log]
            print(f"entry point {etype}: losses {losses}; launches a step "
                  f"{[n for n, _ in log]}")
            require(len(log) == ENTRY_TYPE_STEPS and all(math.isfinite(v) for v in losses),
                    f"entry point {etype}: {len(log)} steps, losses {losses}")
            require(all(once_a_step(etype, n) for n, _ in log),
                    f"entry point {etype}: NT-Xent launches a step {[n for n, _ in log]}")
            out["entry_point"][etype] = {"losses": losses, "launches": [n for n, _ in log]}
    finally:
        entry.make_train_step = real_make
    out["entry_point_s"] = time.perf_counter() - t0
    return out


def transfer_part(base) -> tuple[dict, list]:
    """Part C of phase 23: ``run_transfer_check`` at TRANSFER_CELLS. Returns
    every arm's metrics by cell and the required comparisons that missed
    (phase 23 fails on any, after it has printed every cell)."""
    from simhand_tpu_torch.transfer_check import run_transfer_check

    cells, missed = {}, []
    for label, rn, pre, ft_steps, arms, required in TRANSFER_CELLS:
        t0 = time.perf_counter()
        cell = {}
        for i, (arm, (etype, bn)) in enumerate(arms.items()):
            res = run_transfer_check(str(base / f"transfer_{label}_{arm}"), pre, ft_steps,
                                     TRANSFER_BATCH, bn, experiment_type=etype,
                                     skip_random=not required or i > 0, resnet_size=rn,
                                     device="cuda")
            if res["random"] is not None:
                cell["random"] = res["random"]
            cell[arm] = res["pretrained"]
        seconds = time.perf_counter() - t0
        ref = TRANSFER_REFERENCE[label]
        for arm, m in cell.items():
            print(f"transfer {label} {arm}: lossH_final {m['lossH_final']:.4f} hm_pck "
                  f"{m['hm_pck']:.4f} hm_pck_loose {m.get('hm_pck_loose', float('nan')):.4f} "
                  f"hm_dist {m.get('hm_dist', float('nan')):.4f}; the reference's lossH "
                  f"{ref.get(arm)} (XLA-CPU, JPEG route)")
        for arm in required:
            limit = TRANSFER_MARGIN * cell["random"]["lossH_final"]
            if not cell[arm]["lossH_final"] < limit:
                missed.append(f"{label} {arm}: lossH {cell[arm]['lossH_final']:.4f} not below "
                              f"{TRANSFER_MARGIN} x random's ({limit:.4f})")
        print(f"transfer {label}: {seconds:.1f} s")
        cells[label] = {**cell, "seconds": seconds}
    return cells, missed


def workflow_phase(seed: int) -> dict:
    """Phase 23: the grand loop, the eight experiment types and the transfer
    miniature on the card, under build/workflow_<seed>."""
    import importlib
    import os
    import shutil

    from simhand_tpu_torch import constants, native

    t_phase = time.perf_counter()
    before = set(processes_below(os.getpid()))
    base = native.BUILD_DIR / f"workflow_{seed}"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    os.environ["BASE_PATH"] = str(base / "runs")
    importlib.reload(constants)
    perf = {}
    t0 = time.perf_counter()
    perf["grand_loop"] = grand_loop_part(seed, base)
    perf["grand_loop_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    perf["experiment_types"] = experiment_types_part(seed, base)
    perf["experiment_types_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    perf["transfer"], missed = transfer_part(base)
    perf["transfer_s"] = time.perf_counter() - t0
    left = {pid: cmd for pid, cmd in processes_below(os.getpid()).items() if pid not in before}
    perf["seconds"] = time.perf_counter() - t_phase
    print(f"phase 23 (grand loop, experiment types, transfer): {perf['seconds']:.1f} s; grand "
          f"loop {perf['grand_loop_s']:.1f} s, types {perf['experiment_types_s']:.1f} s, "
          f"transfer {perf['transfer_s']:.1f} s")
    require(sys.modules.get("cv2") is None, "phase 23 imported cv2")
    require(not left, f"processes of phase 23 still running at its end: {left}")
    require(not missed, f"transfer cells missed: {missed}")
    return perf


# phase 24, BASELINE.json's config #4 and the last tools, after phase 23.
# A: ResNet-152 (RN152): its float32 eval forward on the card against the CPU
# on RN152_CPU_IMAGES images within RN152_CPU_RTOL of the largest output;
# the pre-training step of phase 3 at RN152 with exact BatchNorm and with
# stop_grad, RN152_STEPS steps each and RN152_TIMED timed in turns; the same
# step accumulating over ACCUM_K micro-batches against the update of their
# averaged gradient; the entry point at the paper's global batch, PAIRS x
# ENTRY_ACCUM pairs an update, for ENTRY_MICRO_STEPS micro-steps. B: the
# BatchNorm-variant grid at GRID_ARGS (and again, which must run no cell),
# the W8A8 quality check at its defaults (fold_f32 against the eval arm
# within the JAX test's fold-parity gate, FOLD_PCK_GATE and FOLD_EPE_GATE,
# tests/test_int8_infer.py:274-277), and the release check on an exported
# encoder and on a copy with one tensor reshaped.
RN152, RN152_CPU_IMAGES, RN152_CPU_RTOL = "152", 8, 1e-4
RN152_STEPS, RN152_TIMED = 3, 5
# the accumulated gradient against the float32 mean of the micro-batches'
# gradients, relative to each tensor's largest element (the running mean
# and the mean round differently); the parameters against one update of
# that mean, every element within ACCUM_GRAD_RTOL of its update's largest
# element plus lr * |dg| / ADAM_EPS, dg the element's two gradients'
# difference: Adam's first update is x / (|x| + eps) of the LARS-scaled
# gradient x (trust <= 1), whose slope is at most 1 / eps, so where the
# mean cancels to within ~eps of 0 its rounding moves the element by up
# to the update's size (measured on an H100: 0.85 of the largest element
# in the worst tensor, 4,359 elements beyond 1e-5 of it)
ACCUM_K, ACCUM_GRAD_RTOL, ADAM_EPS = 4, 1e-5, 1e-8
ENTRY_ACCUM, ENTRY_MICRO_STEPS = 32, 64
RECIPE_FLAGS = ("--experiment_type", "simhand_w", "--weight_type", "linear", "--diff_type",
                "mpjpe", "--pos_neg", "pos_neg", "--joints_type", "original", "--crop",
                "--resize", "--rotate", "--color_jitter", "-epochs", "100")
GRID_ARGS = ("--seeds", "1", "--rn50_seed", "-1", "--pretrain_steps", "20",
             "--finetune_steps", "20")
FOLD_PCK_GATE, FOLD_EPE_GATE = 1e-3, 1e-5


def rn152_forward_part(seed: int) -> dict:
    """A1: a float32 ResNet-152 ContrastiveModel from ``seed`` (its running
    statistics moved by three train-mode forwards) in eval mode on the card
    (TF32 off) and on the CPU."""
    import torch

    from simhand_tpu_torch.models import ContrastiveModel
    from simhand_tpu_torch.train.state import init_weights

    model = ContrastiveModel(RN152)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        model.train()
        for _ in range(3):
            model(torch.randn(64, SIDE, SIDE, 3, device="cuda", generator=gen))
        model.eval()
        x = torch.randn(RN152_CPU_IMAGES, SIDE, SIDE, 3, device="cuda", generator=gen)
        card = model(x)
        cpu = copy.deepcopy(model).cpu()(x.cpu())
    err = {name: float((a.cpu() - b).abs().max() / b.abs().max())
           for name, a, b in zip(("embedding", "projection"), card, cpu)}
    print(f"ResNet-152 float32 eval forward, card against CPU ({RN152_CPU_IMAGES} images): "
          f"{err} of the largest output")
    require(all(v <= RN152_CPU_RTOL for v in err.values()),
            f"the ResNet-152 forward on the card differs from the CPU's: {err}")
    return err


def rn152_step_part(seed: int) -> dict:
    """A2: phase 3's step at ResNet-152 with exact BatchNorm and with
    stop_grad: step 0 against the dense route, finite losses, a parameter
    change at step 1, #2 and #4 once a step; both timed in turns, the peak
    memory of each, a profile of the exact step."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.train import make_train_step

    batch, cfg = synthetic_batch(seed), step_config()
    states, steps, logs, out = {}, {}, {}, {}
    for variant in ("exact", "stop_grad"):
        state = new_state(seed, resnet=RN152, bn_stop_gradient_stats=variant == "stop_grad")
        ref = compare_routes(state, batch, cfg, f"ResNet-152 {variant} step 0")
        dense = make_train_step(ref.model, dataclasses.replace(cfg, use_pallas=False))
        ref, dense_loss, _ = timed(dense, ref, batch, 1)
        del ref, dense
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        logs[variant] = []
        steps[variant] = launch_counting(make_train_step, K.KERNELS, logs[variant])(
            state.model, cfg)
        states[variant], losses = run_steps(steps[variant], state, batch,
                                            f"ResNet-152 {variant}", steps=RN152_STEPS)
        peak = torch.cuda.max_memory_allocated()
        require(abs(losses[0] - dense_loss) <= 1e-4 * abs(dense_loss),
                f"ResNet-152 {variant}: step-0 loss {losses[0]} against the dense route's "
                f"{dense_loss}")
        out[variant] = {"losses": losses, "dense_step0_loss": dense_loss,
                        "peak_gib": peak / 2**30, "held_before_gib": held / 2**30}
        print(f"ResNet-152 {variant}: losses {losses} (dense step 0 {dense_loss}); peak "
              f"{peak / 2**30:.2f} GiB, {held / 2**30:.2f} GiB held before the steps")
    mean_ms, blocks = in_turns(steps, states, batch, ("exact", "stop_grad", "stop_grad", "exact"),
                               RN152_TIMED)
    for variant, log in logs.items():
        launches = [n for n, _ in log]
        require(all(n["weighted_ntxent_denominator"] == 1 and n["weighted_grad_rows"] == 1
                    and n["ntxent_denominator"] == n["ntxent_grad"] == 0 for n in launches),
                f"ResNet-152 {variant}: #2/#4 not once on every step: {launches}")
        out[variant].update(step_ms=mean_ms[variant], pairs_per_s=PAIRS / mean_ms[variant] * 1e3,
                            steps_launched=len(launches), blocks=blocks[variant])
    print(f"ResNet-152 step (B = {PAIRS} pairs, 128², bf16): exact {mean_ms['exact']:.2f} "
          f"ms/step, {PAIRS / mean_ms['exact'] * 1e3:.1f} pairs/s; stop_grad "
          f"{mean_ms['stop_grad']:.2f} ms/step, {PAIRS / mean_ms['stop_grad'] * 1e3:.1f} "
          f"pairs/s (in turns, blocks {blocks}); #2/#4 once on each of "
          f"{[len(log) for log in logs.values()]} steps")
    del states["stop_grad"], steps["stop_grad"]
    out["exact"]["profile"] = profile = profile_steps(steps["exact"], states["exact"], batch)
    want = 2 * ntxent_launches_a_step("weighted_grad_rows")
    require(profile["profile_ntxent_launches"] == want,
            f"the ResNet-152 profile counts {profile['profile_ntxent_launches']} NT-Xent "
            f"launches a step, not {want} (#2, #4 and their sum passes)")
    return out


def rn152_accumulation_part(seed: int) -> dict:
    """A3: the step at ResNet-152 accumulating over ACCUM_K micro-batches
    (no warmup, so the update runs at the base learning rate; cuDNN's
    deterministic algorithms, so that gradients taken again are the step's):
    the parameters held bit for bit and the BatchNorm statistics moved
    after each of the first ACCUM_K - 1, then one update; the gradient the
    accumulator hands to it against the float32 mean of the ACCUM_K
    gradients taken separately from the same starting state; the
    parameters against one update of it (bit for bit) and of that mean
    (ACCUM_GRAD_RTOL of the largest element plus Adam's slope bound)."""
    import torch

    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.models import contrastive_loss_from_projections
    from simhand_tpu_torch.train import make_train_step
    from simhand_tpu_torch.train.loop import running_stats

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        cfg = step_config()
        state = new_state(seed, resnet=RN152,
                          opt={"accumulate_grad_batches": ACCUM_K, "warmup_epochs": 0})
        reference = copy.deepcopy(state)
        batches = [synthetic_batch(seed + 1 + i) for i in range(ACCUM_K)]
        handed, update = [], state.optimizer._update

        def recording_update(params, grads):
            handed.append([g.clone() for g in grads])
            return update(params, grads)

        state.optimizer._update = recording_update
        log, held, moved = [], [], []
        step = launch_counting(make_train_step, K.KERNELS, log)(state.model, cfg)
        p0 = [p.detach().clone() for p in state.params]
        for b in batches:
            before = [s.clone() for s in running_stats(state.model)]
            state, _ = step(state, b)
            held.append(all(torch.equal(p, q) for p, q in zip(state.params, p0)))
            moved.append(all(not torch.equal(s, q)
                             for s, q in zip(running_stats(state.model), before)))
        del p0, before
        losses = [m["contrastive_loss"] for _, m in log]
        print(f"ResNet-152 accumulation over {ACCUM_K} micro-batches: losses {losses}; "
              f"parameters held {held}; BatchNorm statistics moved {moved}; launches "
              f"{[n for n, _ in log]}")
        require(held == [True] * (ACCUM_K - 1) + [False] and all(moved),
                f"accumulation: parameters held {held}, statistics moved {moved}")
        require(len(handed) == 1 and state.optimizer.count == 1
                and state.optimizer.mini_step == 0,
                f"accumulation: {len(handed)} updates, count {state.optimizer.count}")
        require(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
        require(all(n["weighted_ntxent_denominator"] == n["weighted_grad_rows"] == 1
                    for n, _ in log), f"#2/#4 not once a micro-step: {log}")

        grads = []
        for b in batches:
            reference.model.train()
            _, proj = reference.model(torch.cat([b["transformed_image1"],
                                                 b["transformed_image2"]]))
            loss, _ = contrastive_loss_from_projections(proj, b, cfg)
            grads.append(torch.autograd.grad(loss, reference.params))
        mean = [sum(gs) / ACCUM_K for gs in zip(*grads)]
        del grads
        names = [n for n, _ in state.model.named_parameters()]
        # the head's fc1 bias feeds a train-mode BatchNorm: its gradient is 0
        # up to rounding, with no largest element to be relative to
        grad_err = {n: float((g - m).abs().max() / m.abs().max().clamp_min(1e-30))
                    for n, g, m in zip(names, handed[0], mean)
                    if n != "projection_head.fc1.bias"}
        worst_grad = max(grad_err, key=grad_err.get)
        out = {"losses": losses, "grad_rel_worst": grad_err[worst_grad],
               "grad_rel_worst_tensor": worst_grad}
        for grad_in, label in ((handed[0], "accumulated"), (mean, "mean")):
            twin = copy.deepcopy(reference)
            with torch.no_grad():
                twin.optimizer._update(twin.params, grad_in)
            if label == "accumulated":
                out["params_equal_update_of_accumulated"] = all(
                    torch.equal(p, q) for p, q in zip(state.params, twin.params))
                continue
            lr = state.optimizer.schedule(0)
            norm_rel, elem_rel, over, unexplained = 0.0, 0.0, 0, 0
            with torch.no_grad():
                for p, q, q0, g, m in zip(state.params, twin.params, reference.params,
                                          handed[0], mean):
                    d, u = (p - q).double(), (q - q0).double()
                    norm_rel = max(norm_rel, float(d.norm() / u.norm()))
                    elem_rel = max(elem_rel, float(d.abs().max() / u.abs().max()))
                    floor = ACCUM_GRAD_RTOL * u.abs().max()
                    over += int((d.abs() > floor).sum())
                    slope = lr * (g - m).abs().double() / ADAM_EPS
                    unexplained += int((d.abs() > floor + 1.01 * slope).sum())
            out.update(params_norm_rel_worst=norm_rel, params_elem_rel_worst=elem_rel,
                       params_elements_over=over, params_elements_unexplained=unexplained)
            del twin
        print(f"ResNet-152 accumulation: the accumulated gradient against the float32 mean "
              f"of the {ACCUM_K} gradients {grad_err[worst_grad]:.3e} of its largest element "
              f"(worst {worst_grad}); the parameters equal one update of the accumulated "
              f"gradient: {out['params_equal_update_of_accumulated']}; against one update of "
              f"the mean: {out['params_norm_rel_worst']:.3e} in norm (worst tensor), "
              f"{out['params_elem_rel_worst']:.3e} of the largest element, "
              f"{out['params_elements_over']} elements beyond 1e-5 of it, "
              f"{out['params_elements_unexplained']} of them beyond lr |dg| / eps more")
        require(grad_err[worst_grad] <= ACCUM_GRAD_RTOL,
                f"accumulated gradient {worst_grad} off the mean by {grad_err[worst_grad]}")
        require(out["params_equal_update_of_accumulated"],
                "the parameters differ from one update of the accumulated gradient")
        require(out["params_elements_unexplained"] == 0,
                f"{out['params_elements_unexplained']} parameters off the update of the mean "
                f"by more than {ACCUM_GRAD_RTOL} of the largest plus lr |dg| / eps")
        return out
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def rn152_entry_part(seed: int, base) -> dict:
    """A4: experiments.main with RECIPES.md section 2's flags at ResNet-152,
    B = PAIRS, -accumulate_grad_batches ENTRY_ACCUM, --bn_variant stop_grad,
    on phase 3's cache with --device_augment --use_pallas, for
    ENTRY_MICRO_STEPS micro-steps: every micro-step's loss, #2/#4 launches,
    optimizer count and whether the parameters moved."""
    import torch

    from simhand_tpu_torch import native
    from simhand_tpu_torch.experiments import main as entry
    from simhand_tpu_torch.losses import ntxent_kernels as K

    record = []
    real_make = entry.make_train_step
    # the parameters are compared with the last copy after these micro-steps
    # (1-based): unchanged over 1-31 and 33-63, moved at the updates; the
    # card is waited for after 1 and after 31, so that micro-steps 2-31
    # run as the entry point runs them, with no check and no wait
    checked, timed = {ENTRY_ACCUM - 1, ENTRY_ACCUM, 2 * ENTRY_ACCUM - 1, 2 * ENTRY_ACCUM}, {
        1, ENTRY_ACCUM - 1}
    updates_at = {ENTRY_ACCUM, 2 * ENTRY_ACCUM}
    last = {}

    def checking_make(*a, **k):
        step = real_make(*a, **k)

        def run(state, batch):
            i = len(record) + 1
            if i == 1:
                last["params"] = [p.detach().clone() for p in state.params]
            if i in updates_at:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            before = {fn.__name__: fn.launches for fn in K.KERNELS}
            count = state.optimizer.count
            state, metrics = step(state, batch)
            rec = {"loss": metrics["contrastive_loss"].detach(),
                   "launches": {fn.__name__: fn.launches - before[fn.__name__]
                                for fn in K.KERNELS},
                   "count": state.optimizer.count,
                   "lr": state.optimizer.schedule(count) if state.optimizer.count > count
                   else None}
            if i in timed | updates_at:
                torch.cuda.synchronize()
                rec["t"] = time.perf_counter()
                if i in updates_at:
                    rec["update_ms"] = (rec["t"] - t0) * 1e3
            if i in checked:
                rec["moved"] = any(not torch.equal(p, q)
                                   for p, q in zip(last["params"], state.params))
                last["params"] = [p.detach().clone() for p in state.params]
            record.append(rec)
            return state, metrics

        return run

    argv = [*RECIPE_FLAGS, "-sources", "synthetic",
            "--cache_dir", str(native.BUILD_DIR / f"cache_fed_{seed}"), "--device_augment",
            "--use_pallas", "-batch_size", str(PAIRS), "-resnet_size", RN152,
            "-accumulate_grad_batches", str(ENTRY_ACCUM), "--bn_variant", "stop_grad",
            "--max_steps", str(ENTRY_MICRO_STEPS), "-save_period", "100",
            "-experiment_name", "rn152_accumulation", "-seed", str(seed),
            "--resume_path", str(base / "rn152_checkpoints")]
    t0 = time.perf_counter()
    entry.make_train_step = checking_make
    try:
        state = entry.main(argv, device="cuda")
    finally:
        entry.make_train_step = real_make
    run_s = time.perf_counter() - t0
    opt_cfg = state.optimizer.cfg
    require(len(record) == ENTRY_MICRO_STEPS and state.step == ENTRY_MICRO_STEPS,
            f"the entry point ran {len(record)} micro-steps")
    updates = [i + 1 for i, r in enumerate(record) if r["lr"] is not None]
    lrs = [r["lr"] for r in record if r["lr"] is not None]
    moved = {i + 1: r["moved"] for i, r in enumerate(record) if "moved" in r}
    losses = [float(r["loss"]) for r in record]
    first, last_timed = sorted(timed)
    ms = (record[last_timed - 1]["t"] - record[first - 1]["t"]) / (last_timed - first) * 1e3
    update_ms = [record[u - 1]["update_ms"] for u in sorted(updates_at)]
    want_lr = 1e-4 * math.sqrt(1024 * ENTRY_ACCUM)
    print(f"ResNet-152 entry point (B = {PAIRS} pairs a micro-step, x{ENTRY_ACCUM} = "
          f"{PAIRS * ENTRY_ACCUM} pairs an update; each micro-step's NT-Xent negatives are its "
          f"own {2 * PAIRS} images, as in the reference and in JAX): {len(record)} "
          f"micro-steps in {run_s:.1f} s; {ms:.2f} ms an accumulation micro-step over "
          f"micro-steps {first + 1}-{last_timed} (no check or wait among them; the epochs of "
          f"phase 3's cache end every {CACHE_IMAGES // PAIRS} micro-steps, inside the window); "
          f"update micro-steps {sorted(updates_at)} {[round(v, 2) for v in update_ms]} ms "
          f"(a wait before and after each); updates at micro-steps {updates} with lr {lrs}; "
          f"parameters moved after {moved}; base_lr {opt_cfg.base_lr} "
          f"(lr * sqrt(1024 * {ENTRY_ACCUM}) = {want_lr}); losses first/last "
          f"{losses[:2]} / {losses[-2:]}")
    require(all(math.isfinite(v) for v in losses), f"non-finite entry-point losses {losses}")
    require(all(r["launches"]["weighted_ntxent_denominator"] == 1
                and r["launches"]["weighted_grad_rows"] == 1
                and r["launches"]["ntxent_denominator"] == r["launches"]["ntxent_grad"] == 0
                for r in record), "#2/#4 not once on every micro-step")
    require(updates == [ENTRY_ACCUM, 2 * ENTRY_ACCUM] and state.optimizer.count == 2,
            f"the optimizer updated at micro-steps {updates}, not at {ENTRY_ACCUM} and "
            f"{2 * ENTRY_ACCUM}")
    # the parameters move at an update whose learning rate is not 0 and at no
    # other micro-step (the recipe's warmup starts from lr 0)
    # unchanged over micro-steps 1-31 and 33-63 (compared after 31 and 63
    # with the copies before 1 and after 32)
    require(sorted(moved) == sorted(checked)
            and [u for u, v in moved.items() if v]
            == [u for u, lr in zip(updates, lrs) if lr != 0.0] and any(moved.values()),
            f"the parameters moved after {moved}; updates {updates}, lr {lrs}")
    require(math.isclose(opt_cfg.base_lr, want_lr, rel_tol=1e-12),
            f"base_lr {opt_cfg.base_lr}, not {want_lr}")
    return {"micro_steps": len(record), "ms_an_accumulation_micro_step": ms,
            "update_micro_step_ms": update_ms, "run_s": run_s,
            "pairs_per_s": PAIRS / ms * 1e3, "updates_at": updates, "update_lrs": lrs,
            "params_moved_after": moved, "base_lr": opt_cfg.base_lr, "losses": losses,
            "launches_a_micro_step": {k: sorted({r["launches"][k] for r in record})
                                      for k in record[0]["launches"]}}


def grid_part(base) -> dict:
    """B1: the grid at GRID_ARGS, then again: two cell lines, no error line,
    the random arm on the exact cell alone; the second run starts no cell
    and adds no line."""
    import contextlib
    import io

    from simhand_tpu_torch import bn_grid

    out = base / "bn_grid.jsonl"
    argv = [*GRID_ARGS, "--out", str(out), "--workdir", str(base / "grid_cells"),
            "--device", "cuda"]
    started, runs = [], []

    def counting_runner(*a):
        started.append(list(a[0]))
        return bn_grid.run_cell(*a)

    for _ in range(2):
        t0 = time.perf_counter()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            summary = bn_grid.main(argv, cell_runner=counting_runner)
        print(text.getvalue().strip())
        lines = [json.loads(line) for line in text.getvalue().splitlines() if line.strip()]
        runs.append({"seconds": time.perf_counter() - t0, "started": len(started),
                     "errors": [line for line in lines if "error" in line],
                     "records": bn_grid.read_records(str(out)), "summary": summary})
    first, second = runs
    recs = first["records"]
    print(f"grid: {first['started']} cells in {first['seconds']:.1f} s, then "
          f"{second['started'] - first['started']} in {second['seconds']:.1f} s")
    require(not first["errors"], f"grid cells failed: {first['errors']}")
    require(len(recs) == 2 and [r["cell"][2] for r in recs] == ["exact", "stop_grad"],
            f"grid: {recs}")
    require(recs[0]["random"] is not None and recs[1]["random"] is None,
            "grid: the random arm not on the exact cell alone")
    require(all(math.isfinite(v) for r in recs for v in r["pretrained"].values()),
            f"grid: non-finite metrics {recs}")
    require(second["started"] == first["started"] == 2 and second["records"] == recs
            and not second["errors"], "grid: the second run started a cell or added a line")
    return {"records": recs, "summary": first["summary"],
            "seconds": [r["seconds"] for r in runs]}


def int8_quality_part(base) -> dict:
    """B2: the W8A8 quality check at its defaults on the card."""
    from simhand_tpu_torch.int8_quality import run_int8_quality

    t0 = time.perf_counter()
    res = run_int8_quality(str(base / "int8_quality"), device="cuda")
    seconds = time.perf_counter() - t0
    for arm in ("eval", "fold_f32", "int8"):
        print(f"int8 quality {arm}: {res[arm]}")
    print(f"int8 quality: {res['int8_sites']} int8 sites; int8 less fold_f32 "
          f"{res['delta_int8_vs_f32']}; {seconds:.1f} s")
    require(all(math.isfinite(v) for arm in ("eval", "fold_f32", "int8")
                for v in res[arm].values()), f"non-finite int8 quality meters {res}")
    ev, fold = res["eval"], res["fold_f32"]
    require(abs(ev["hm_pck"] - fold["hm_pck"]) < FOLD_PCK_GATE
            and abs(ev["epe_mean"] - fold["epe_mean"]) < FOLD_EPE_GATE * (1 + fold["epe_mean"]),
            f"fold_f32 moves the eval arm's meters: {ev} against {fold}")
    return {**res, "seconds": seconds}


def release_part(seed: int, base) -> dict:
    """B3: verify_release on phase 16's --export_torch file (exported here by
    one entry-point step when phase 16 has not run) and on a copy with one
    tensor reshaped."""
    import contextlib
    import io

    import torch

    from simhand_tpu_torch import native, verify_release
    from simhand_tpu_torch.experiments import main as entry

    export = native.BUILD_DIR / f"entry_point_{seed}" / "resnet50_simhand.pth"
    if not export.exists():
        export = base / "resnet50_simhand.pth"
        entry.main(["--experiment_type", "simhand_w", "--crop", "--resize", "--rotate",
                    "-sources", "synthetic", "--cache_dir",
                    str(native.BUILD_DIR / f"cache_fed_{seed}"), "--device_augment",
                    "-batch_size", str(PAIRS), "-resnet_size", RESNET, "-epochs", "1",
                    "--max_steps", "1", "-experiment_name", "release_export",
                    "--export_torch", str(export)], device="cuda")
    sd = torch.load(export, weights_only=True)
    sd["layer1.0.conv1.weight"] = torch.zeros(64, 64, 3, 3)
    corrupt = base / "corrupt.pth"
    torch.save(sd, corrupt)
    out = {}
    for label, path in (("export", export), ("corrupt", corrupt)):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = verify_release.main([str(path)])
        out[label] = {"rc": rc, **json.loads(text.getvalue().strip().splitlines()[-1])}
        print(f"release check on the {label} ({path.name}): {out[label]}")
    require(out["export"] == {"rc": 0, "ok": True, "keys_checked": 318,
                              "roundtrip_exact": True, "problems": []},
            f"the release check refused the export: {out['export']}")
    require(out["corrupt"]["rc"] == 1 and not out["corrupt"]["ok"],
            f"the release check accepted the corrupt copy: {out['corrupt']}")
    return out


def config4_phase(seed: int) -> dict:
    """Phase 24: ResNet-152 and gradient accumulation (A1-A4), the grid, the
    W8A8 quality check and the release check (B1-B3), under
    build/config4_<seed>."""
    import importlib
    import os
    import shutil

    import torch

    from simhand_tpu_torch import constants, native

    t_phase = time.perf_counter()
    before = set(processes_below(os.getpid()))
    base = native.BUILD_DIR / f"config4_{seed}"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    os.environ["BASE_PATH"] = str(base / "runs")
    importlib.reload(constants)
    perf, seconds = {}, {}
    for name, part in (("forward", lambda: rn152_forward_part(seed)),
                       ("step", lambda: rn152_step_part(seed)),
                       ("accumulation", lambda: rn152_accumulation_part(seed)),
                       ("entry_point", lambda: rn152_entry_part(seed, base)),
                       ("grid", lambda: grid_part(base)),
                       ("int8_quality", lambda: int8_quality_part(base)),
                       ("release", lambda: release_part(seed, base))):
        t0 = time.perf_counter()
        perf[name] = part()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    left = {pid: cmd for pid, cmd in processes_below(os.getpid()).items() if pid not in before}
    perf["seconds"] = {**seconds, "phase": time.perf_counter() - t_phase}
    print(f"phase 24 (ResNet-152, accumulation, grid, W8A8 quality, release check): "
          f"{perf['seconds']['phase']:.1f} s; by part "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    require(sys.modules.get("cv2") is None, "phase 24 imported cv2")
    require(not left, f"processes of phase 24 still running at its end: {left}")
    return perf


def processes_below(pid: int) -> dict[int, str]:
    """Every process below ``pid`` (children, theirs, ...) by pid, with its
    command, from the parent links in /proc."""
    import os

    parent, command = {}, {}
    for entry in os.listdir("/proc"):
        try:
            stat = open(f"/proc/{entry}/stat").read() if entry.isdigit() else ""
        except OSError:
            continue
        if stat:
            parent[int(entry)] = int(stat[stat.rindex(")") + 2:].split()[1])
            command[int(entry)] = stat[stat.index("(") + 1:stat.rindex(")")]
    below, todo = {}, [pid]
    while todo:
        kids = [c for c, p in parent.items() if p == todo[-1]]
        todo.pop()
        below.update({c: command[c] for c in kids})
        todo += kids
    return below


def stop_processes_left() -> dict[int, str]:
    """Kills and reaps every process still running below this one, and
    returns what it found (none, when each phase stopped what it started)."""
    import os
    import signal

    left = processes_below(os.getpid())
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in left:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
    deadline = time.monotonic() + 5
    while processes_below(os.getpid()) and time.monotonic() < deadline:
        time.sleep(0.05)
    return left


def plain_family(state, batch) -> tuple[dict, dict]:
    """simhand-base steps through kernels #1 and #3: step 0's loss and
    dL/dprojections against the dense route on the same projections, the
    launches, and a profile with #1's and #3's ms and launches a step."""
    from simhand_tpu_torch.losses import ntxent_kernels as K
    from simhand_tpu_torch.train import make_train_step

    cfg = step_config(experiment_type="simhand-base")
    compare_routes(state, batch, cfg, "plain family step 0")
    step = make_train_step(state.model, cfg)
    K.reset_launches()
    losses = []
    for _ in range(PLAIN_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["contrastive_loss"]))
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    print(f"plain family (simhand-base) losses {losses}; launches {launches}")
    require(all(math.isfinite(v) for v in losses), "non-finite plain-family loss")
    require(launches["ntxent_denominator"] == PLAIN_STEPS
            and launches["ntxent_grad"] == PLAIN_STEPS,
            f"plain kernels did not launch on every step: {launches}")
    perf = profile_steps(step, state, batch)
    for name in ("ntxent_denominator", "ntxent_grad"):
        group, want = NTXENT_PROFILE_GROUPS[name][0], ntxent_launches_a_step(name)
        require(perf[f"profile_{group}_launches"] == want,
                f"the plain family's profile counts {perf[f'profile_{group}_launches']} "
                f"launches of {name} a step, not {want} (the kernel and its sum pass)")
    return launches, perf


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    # phase 20's and 21's processes: this script started again as one of them
    parser.add_argument("--dp-role", choices=("world1", "rank", "sharded_world1", "sharded_rank"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--dp-rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--dp-port", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--dp-out", help=argparse.SUPPRESS)
    parser.add_argument("--dp-proj", help=argparse.SUPPRESS)
    args = parser.parse_args()
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from simhand_tpu_torch import native
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 1

    if args.dp_role:
        return dp_child(args.dp_role, args.seed, args.dp_rank, args.dp_port, args.dp_out,
                        args.dp_proj)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    # one compiler for each source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(native.build, SOURCES))
    print(f"built {[lib.name for lib in libs]} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())
    card = card_line()
    print(card)

    report = kernel_phase(args.seed)
    bn_report = bn_kernel_phase(args.seed)
    fused_bn_report = fused_bn_kernel_phase(args.seed)
    conv_report = conv_kernel_phase(args.seed)
    conv_report.update(conv_f32_phase(args.seed))
    conv_bias_report = conv_bias_phase(args.seed)
    block_report = block_kernel_phase(args.seed)
    state, batch, main_launches, perf = main_path(args.seed)
    cache_fed_perf = cache_fed_path(args.seed, state, batch)
    entry_perf, entry_launches = entry_point_path(args.seed, cache_fed_perf["composed_ms"])
    finetune_perf, finetune_launches = finetune_path(args.seed)
    bn_launches, bn_perf = epilogue_path(args.seed, state, batch, perf["step0_loss"])
    fused_bn_launches, fused_bn_perf = fused_bn_path(args.seed, state, batch, perf["step0_loss"])
    conv_launches, conv_perf = conv1x1_path(args.seed, state, batch)
    plain_launches, plain_perf = plain_family(state, batch)
    del state
    f32_launches, f32_perf = conv1x1_f32_path(args.seed, batch)
    conv_launches.update(f32_launches)
    del batch
    serve_launches, serve_perf, kernel_walk = serving_path(args.seed)
    server_perf = server_phase(kernel_walk)
    del kernel_walk
    entry_serving_perf = serving_entry_points(args.seed)
    dp_perf, dp_launches = data_parallel_phase(args.seed)
    from simhand_tpu_torch.data.grain_loader import stop_worker_server

    t19 = time.perf_counter()
    try:
        mining_perf = mining_path(args.seed)
        loader_perf = loader_phase(args.seed)
    finally:
        stop_worker_server()
    phase_19_s = time.perf_counter() - t19
    print(f"phase 19 (mining and the loader): {phase_19_s:.1f} s")
    sharded_perf, sharded_launches = sharded_phase(args.seed)
    mano_perf = mano_side_phase(args.seed)
    workflow_perf = workflow_phase(args.seed)
    config4_perf = config4_phase(args.seed)
    left = stop_processes_left()
    require(not left, f"processes left running after the phases: {left}")

    kernels = []
    for name, shapes in report.items():
        path_launches = main_launches if name.startswith("weighted") else plain_launches
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES["ntxent"],
            "replaces": REPLACES[name], "launches": path_launches[name],
            **shapes[MAIN_SHAPE], "library_ms": None, "at": shapes,
            "sharded_launches_a_rank_a_step": dp_launches[name],
            "fsdp_launches_a_rank_a_step": sharded_launches[name],
            **({"entry_point_launches": entry_launches[name]} if name in entry_launches
               and name.startswith("weighted") else {}),
            **({"resnet152_launches_a_micro_step":
                config4_perf["entry_point"]["launches_a_micro_step"][name],
                "resnet152_step_device_ms": config4_perf["step"]["exact"]["profile"][
                    f"profile_{NTXENT_PROFILE_GROUPS[name][0]}_ms"]}
               if name.startswith("weighted") else {}),
        })
    for name, shapes in bn_report.items():
        main_row = shapes[f"{BN_MAIN_SHAPE[name]}_bf16"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES["bn_epilogue"],
            "replaces": BN_REPLACES[name], "launches": bn_launches[name],
            **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "sum_device_ms",
                                        "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            **{k: main_row[k] for k in ("exact_pair_ms", "exact_pair_device_ms",
                                        "pair_bound_ms")},
            "fsdp_launches_a_rank_a_step": sharded_launches["fsdp_bn"][name],
            "at": shapes,
        })
    main_row = fused_bn_report["bn_backward_reduces"]["stem_bf16"]
    kernels.append({
        "name": "bn_backward_reduces", "route": "cuda", "source": SOURCES["bn_epilogue"],
        "replaces": FUSED_BN_REPLACES["bn_backward_reduces"],
        "launches": fused_bn_launches["bn_backward_reduces"],
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_device_ms")},
        "finetune_launches": finetune_launches["bn_backward_reduces"],
        "data_parallel_launches_a_rank_a_step": sharded_launches["bn_backward_reduces"],
        "fsdp_launches_a_rank_a_step": sharded_launches["fsdp_bn"]["bn_backward_reduces"],
        "finetune_rel_err": finetune_perf["bn_backward_reduces_rel"],
        "at": fused_bn_report["bn_backward_reduces"],
    })
    for name, shapes in conv_report.items():
        main_row = shapes[CONV_MAIN_SHAPE]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES["conv1x1"],
            "replaces": CONV_REPLACES[name.removesuffix("_f32")], "launches": conv_launches[name],
            **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "sum_device_ms",
                                        "plain_ms", "bound_ms", "bound_by", "matmul_ms",
                                        "ratio_to_matmul")},
            "library_ms": None, "at": shapes,
            **({"sharded_launches_a_rank_a_step": dp_launches[name],
                "fsdp_launches_a_rank_a_step": sharded_launches[name]}
               if name in dp_launches else {}),
        })
    main_row = conv_bias_report["conv_bias_act"][CONV_BIAS_MAIN_SHAPE]
    kernels.append({
        "name": "conv_bias_act", "route": "cuda", "source": SOURCES["conv_bias"],
        "replaces": CONV_BIAS_REPLACES["conv_bias_act"],
        "launches": serve_launches["conv_bias_act"],
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library_device_ms")},
        "at": conv_bias_report["conv_bias_act"],
    })
    main_row = block_report["bottleneck_block"][BLOCK_MAIN_SHAPE]
    kernels.append({
        "name": "bottleneck_block", "route": "cuda", "source": SOURCES["conv_bias"],
        "replaces": BLOCK_REPLACES["bottleneck_block"],
        "launches": serve_launches["bottleneck_block"],
        **{k: main_row[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                    "bound_by", "cudnn_block_ms", "cudnn_block_device_ms",
                                    "share_over_one_ulp")},
        "library_ms": None, "at": block_report["bottleneck_block"],
    })
    for k in kernels:
        print(f"kernel {k['name']}: launches={k['launches']} max_abs_err={k['max_abs_err']:.3e} "
              f"ms={k['ms']:.4f} device_ms={k['device_ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.4f}")
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s in all")
    print(json.dumps({"step": perf, "cache_fed_step": cache_fed_perf,
                      "entry_point": entry_perf, "finetune": finetune_perf,
                      "epilogue_step": bn_perf, "fused_bn_step": fused_bn_perf,
                      "conv1x1_step": conv_perf, "conv1x1_f32_step": f32_perf,
                      "plain_family_step": plain_perf,
                      "serving": serve_perf, "server": server_perf,
                      "serving_entry_points": entry_serving_perf,
                      "mining": mining_perf, "loader": loader_perf,
                      "data_parallel": dp_perf, "sharded": sharded_perf, "mano": mano_perf,
                      "workflow": workflow_perf, "config4": config4_perf,
                      "phase_19_s": phase_19_s, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
