#!/usr/bin/env python3
"""Drive the PyTorch port (bcosification_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from ops/cuda/csrc with nvcc;
3. kernels: each kernel against its plain PyTorch version at six
   main-path shapes, in fp32 (TF32 off; max |diff| <= 1e-5 max |ref|) and
   bf16 (against the plain version in fp32 on the same rounded inputs;
   ||diff|| <= 1e-2 ||ref||); then (after phase 6, whose streaming rate it
   uses) each kernel's time at every shape one main-path call gives it,
   with its achieved TFLOP/s and GB/s, beside its bound (at the data-sheet
   and at the measured memory rate), its plain version and torch.matmul on
   the same GEMM, and each kernel's time per call beside its earlier
   record (PREVIOUS_MS); K3 is checked with both eps_outside values, also
   at five shapes of the train step (TRAIN_CHECK_SHAPES); K1, K2 and K3 in
   fp32 at ragged shapes (FP32_RAGGED_SHAPES: M = 49 and 3149, N = 1000 and
   N % 4 != 0, K % 4 != 0, a misaligned x, split-K at M = 49; tma_operands
   pads or realigns every kernel's operands there, counted, then its count
   restarts at 0);
4. parity: the full-width B-cosified ResNet-50 (224x224, gamma-calibrated),
   fp32, 2 images: the fast forward + explanation on the GPU (kernels)
   against the same call on the CPU (plain versions; W within 1e-3, the
   pre-logit features within 1e-4, identical argmax), and the module path
   (autograd through the kernels) against the fast path (1e-4);
5. throughput: batch 128, 224x224, bf16: forward + explanation and
   forward-only images/s, each over one window of calls in a row, with the
   kernel launch counts of one call each (and, for comparison with the
   older records, the median of 10 single calls);
6. probe: K4, the streaming add, against its plain version bit for bit at
   [401408, 256] bf16, then the probe's entry point
   (probes/stream_bandwidth.measure): K4's and PyTorch's a + b + c time and
   rate beside the 3.35 TB/s data-sheet rate;
7. serving: the calibrated net exported (serving.export_forward and
   .export_explain), saved to bytes and loaded back; at batch 128, bf16 the
   loaded programs against the eager calls (argmax identical, logits and W
   within 1e-6 relative: the same ops and kernels on the same inputs), their
   launch counts, forward-only, forward + explanation and a mixed loop in
   which 1 batch in 10 is explained, beside the harmonic model of the two
   and the eager calls timed the same way; then explain() on one image
   (RGBA finite, in [0, 1]);
8. train: the supervised recipe (scripts/bench_train.py: Adam 1e-4 with the
   90-epoch cosine, AGC, UniformOffLabels BCE, EMA, bf16 AMP) on the
   calibrated net at batch 64, 224x224: Trainer.fit for one epoch of 20
   steps on one repeated batch made from a seed (initial validation,
   validation, EMA validation, one checkpoint in a temporary directory),
   then a resume from that checkpoint for one step. It prints the loss per
   5 steps (finite, falling), K3's launches per train step (34: every
   stride-1 1x1 conv), the step's ms and img/s over a window of 10 steps in
   a row after a warm-up step, the host's issue time per step and the peak
   memory; then K3's time at each shape of one train step beside its bound;
   then one fp32 train step of the small flagship on the GPU against the
   same step on the CPU (loss, every gradient, the BN running_var), and its
   bf16 amp gradient on the GPU against the fp32 one on the CPU (every leaf,
   also as a ratio to the CPU amp gradient's own distance from it);
9. entry points: a synthetic ImageNet-layout JPEG tree made from a seed
   (data/synthetic.py: 10 classes, 704 train and 128 val JPEGs of 500x375
   at quality 90) with IMAGENET_PATH pointing at it; the resnet_50
   Experiment's train loader alone (img/s, the host's CPU count, its
   workers); the host-to-card copy of one batch; Trainer.fit for one epoch
   (bf16 amp) fed by that loader, its img/s beside phase 8's repeated-batch
   rate and K3's launches per step; then, in-process, ``train
   --fast_dev_run`` (resuming from the fit's checkpoint), ``evaluate
   --reload last`` (its top-1/top-5 equal to the val_acc1/val_acc5 logged
   for the same weights) and ``evaluate --reload fresh``, with K1's and
   K3's launches per eval batch; then the eval-mode input gradient without
   explain (fault C1's route: the 1x1 convs unfused, K3 and cuDNN) of the
   calibrated full-width net in fp32, GPU against CPU, within ten times
   the CPU's own spread under 1e-7 relative input noise, and phase 5's
   launch counts again;
10. DenseNet-121 (the densenet_121 recipe; growth 32, blocks 6/12/24/16,
   random init from SEED, gamma-calibrated), on the same JPEG tree: K3 and
   K2 against their plain versions at six of its shapes in both dtypes
   (phase 3's bounds), then timed at all 62 shapes of one forward (K3) and
   one explanation (K2) beside their bounds, plain versions and
   torch.matmul; fp32 parity on 2 images of the hand-scheduled pass
   (explain/fast_densenet.py), GPU against CPU (W within ten times the
   CPU's own spread under 1e-7 relative input noise, pre-logits 1e-4,
   argmax identical), and the generic autograd W against it (1e-4);
   forward-only and fwd+explain images/s at batch 128, bf16, over windows
   of about 1.7 s, with their launch counts (K3 62 / K2 0 / K1 0 and K3 62
   / K2 62 / K1 0), host issue time and peak memory; the forward and the
   explanation programs of the DenseNet-121 cut to two dense layers in the
   first block and one in each of the others (full width;
   SERVE_DENSENET_BLOCKS) exported, loaded from bytes and
   held to the eager calls (fault C3), their loaded rates those of the cut
   net; Trainer.fit of the Experiment at batch 64, bf16 amp, on one
   repeated batch (a falling loss, K3 62 launches per step, the step's
   img/s, host ms and peak memory); then ``train --fast_dev_run``
   resuming from it and ``evaluate --reload last`` equal to the logged
   accuracies;
11. CLIP-RN50 (the clip_bcosification recipe's student, pooled and
   attn-unpool; widths 64 / 2048, 32 heads, embed_dim 1024, random init
   from SEED, gamma-calibrated), on the same JPEG tree: K1, K2 and K3
   against their plain versions at six CLIP shapes in both dtypes (phase
   3's bounds; at the c_proj shape K2 and K3 with the linear norm,
   eps_outside); per head, fp32 parity on 2 images of the text-grounded
   explanation (explain/fast_clip.py), GPU against CPU (scores 1e-4; W as
   phase 10 holds it) and the module's autograd against it (scores 1e-4, W
   ten times the CPU's spread: the module runs K3 and the BN apart); the
   encode and the text fwd+explain images/s at batch 128, bf16, with their
   launch counts (encode: K3 36, +1 unpooled; explanation: K1 36, K2 36,
   +1 K2 and +1 K3 unpooled), host issue time and peak memory; the pooled
   tower cut to one bottleneck per stage (full width; SERVE_CLIP_LAYERS):
   its text explanation and forward exported, loaded from bytes and held to
   the eager calls, the loaded rate that of the cut net; the zero-shot
   classifier of a random-init text tower over 1000 classes x 80 templates
   in bf16 (tokenize and tower timed), one class (80 prompts) in fp32
   against the CPU (1e-4), and
   ``zeroshot_evaluate`` of both heads over the tree's val split; then
   each kernel's time at every shape of one attn-unpool encode (K3) and
   text explanation (K1, K2, K3) beside its bound;
12. CLIP-RN50 knowledge distillation (the clip_bcosification KD recipe:
   Adam 1e-4 with the cosine, AGC, SigLIP with logit scale 10 and bias -10;
   phase 11's calibrated students, the random-init teacher of clip/load.py):
   K3 against its plain version at every distinct shape of a KD train step
   at batch 64 in both dtypes (phase 3's bounds; the unpooled c_proj with
   eps_outside); per head, Trainer.fit of the ImageNet KD Experiment
   (-> fit_kd) for one epoch of 20 steps at batch 64, 224x224, bf16 amp on
   one repeated batch made from SEED, then a resume for one step: the loss
   per 5 steps (finite), the launches (K3 36 per step pooled, 37 attn-unpool;
   K1 and K2 0), the teacher's parameter hash against a fresh load's, the
   student's moved, the best checkpoint the minimum val_loss; the KD step's
   ms, img/s, host issue ms, peak memory, card busy time and top kernels
   over a window of 10 steps, and the bf16 teacher forward alone; one fp32
   KD step of each full-width head on 2 images, GPU against CPU (the loss
   1e-5, every gradient within ten times the CPU's spread under 1e-7
   relative input noise, the BN running_var within ten times the CPU's
   spread in it under that noise or the batch reversed); K3's time at every shape
   of one attn-unpool KD step beside its bound, plain version and
   torch.matmul; a synthetic CC3M tree (data/synthetic.py: 332 train shards,
   4 of them distinct, and 2 val shards of 70 JPEG + caption pairs) with
   CC3M_PATH at it: the CC3M train loader alone (img/s), Trainer.fit of the
   CC3M KD Experiment for 5 steps from the calibrated pooled student (a
   conversion-time student contracts to ~0 in eval mode, and phase 16 reads
   this experiment), then ``train --dataset CC3M
   ... _sigLip_kd_CC3M_bcosification --fast_dev_run`` in process twice, each
   resuming; then ``train --fast_dev_run`` of the ImageNet KD
   config over phase 9's JPEG tree, resuming from the fit, whose epoch
   metrics hold ``zeroshot_ImageNet_acc1`` (the per-epoch zero-shot, K3 in
   its encode);
13. ViT-B/16 (the vit_bcosification recipe's bcosifyv2 config: dim 768,
   depth 12, 12 heads, mlp 3072, patch 16, 196 tokens, no bias, GELU, the
   head on the token mean, the LogitLayer; random init from SEED, and its
   useBias_noGelu_gapReorder variant): K3 and K2 against their plain
   versions at the five shapes of its bias-free B-cos linears in both
   dtypes (phase 3's bounds; the linear norm, eps_outside; K2 with the bare
   cotangent, its bf16 scratch route at linear1's Cout 3072); per config,
   fp32 parity on 2 images, GPU against CPU, of the logits and of W from
   the hand-scheduled pass (explain/fast_vit.py) and from the module path
   (autograd), and the two paths against each other (W within ten times
   the CPU's spread under 1e-7 relative input noise, pre-logits 1e-4,
   argmax identical), and its launch counts (K3 38 per forward, K2 38 per
   explanation, K1 0; the variant 12 and 12); forward-only and fwd+explain
   (fast pass and module path) images/s at batch 128, bf16, with launch
   counts, host issue time, peak memory, the card's busy time and its top
   kernels (torch.profiler); both programs of the ViT-B/16 cut to
   VIT_EXPORT_DEPTH encoders (full width) exported, loaded from bytes and
   held to the eager calls, the export seconds and the cut net's loaded
   rate; ``evaluate
   --base_network vit_bcosification --reload fresh`` over phase 9's tree,
   K3 38 per eval batch; then each kernel's time at every shape of one
   explanation beside its bound, plain version and torch.matmul;
14. ViT training and the from-scratch ViTs of vit_final (random init from
   SEED): K3 against its plain version at every distinct shape of a
   ViT-B/16 train step at batch 64 and of the ViT-C B forward at batch 128
   in both dtypes (phase 3's bounds, eps_outside); (a) ViT-B/16 of phase 13
   under its own recipe (Adam, AGC, UniformOffLabels BCE, bf16 amp) at
   batch 64: K3 38 launches per step (K1, K2 none), the step's ms, img/s,
   host issue ms, peak memory, card busy time and top kernels over a window
   of 10 steps, finite losses; one fp32 step on 2 images on the GPU against
   the CPU through Adam's first moment (within ten times the CPU's spread
   under 1e-7 relative input noise; the loss 1e-5) and the updated
   parameters (within 2e-3 of the step-0 lr beyond one fp32 spacing); (b) the ViT-C B
   (bcos_vitc_b_patch1_14: a stem of six 3x3 B-cos convs with the group
   LayerNorm, 11 encoders of BcosLinear, the logit layer inside): fp32 on
   2 images, GPU against CPU (pre-logits and logits 1e-4, W of the module
   path within ten times the CPU's spread, argmax identical) and the
   hand-scheduled pass with the stem's transpose against the module path;
   the fp32 export_explain of the ViT-C B at depth 1 (VIT_EXPORT_DEPTH)
   loaded from bytes, its
   W against the module path's within that bound (fault C5; the bf16
   round trip of the same pass is (c)'s); forward-only and fwd+explain
   (module path) at batch 128, bf16, K3 35 per forward, and its recipe's
   train step at batch 128; (c) the B-cos ViT-B of vit_final
   (bcos_simple_vit_b_patch16_224): phase 13's parity of the fast pass and
   the module path, then the exported forward and explanation at depth 1,
   loaded from bytes and held to the eager calls; (d) ``train --base_network
   vit_final --fast_dev_run --amp`` of bcos_vitc_ti_patch1_14 and of the
   standard vitc_ti_patch1_14 (3 channels, no K3) over phase 9's tree, each
   followed by ``evaluate --reload last`` equal to the logged accuracies;
   (e) K3's time at every shape of (a) and (b) beside its bound, plain
   version and torch.matmul;
15. the analyses (interpretability/) on phase 4's calibrated ResNet-50 in
   bf16 (the images cast from f32): LocalisationAnalyser of the
   50_3x3_noconfthresh config on 4096 seeded synthetic images (colour
   blocks, gradients, stripes, noise) labelled by the net's own argmax (a
   random-init net gets real labels right only by chance, and its logit
   bias -log(999) keeps sigmoid(logit) below 0.5, hence no confidence
   threshold), which must fill at least 8 3x3 grids of 672^2: the images
   drawn, their distinct classes, compute_sorted_confs' seconds, the mean
   metric and grids/s of Ours; on one grid every explainer (Ours,
   OursRelative, IxG, Grad, IntGrad of 20 steps, GB, DeepLIFT also in
   explanation mode, Occlusion 16/8, RISE of 500 masks, LIME of 200
   samples) with its seconds and launches (Ours: K1 36, K2 37, K3 1; the
   gradient explainers fault C1's route: K3 34, no K1 or K2; under
   DeepLIFT no K1); fp32 Ours and GB on that grid's first target
   (LOC_PARITY_TARGETS of its 9), GPU against CPU (W 1e-3, its score
   1e-3); ``localisation.main`` on phase 9's trained resnet_50
   and ``localisation_sweep`` on Ours and IxG (their files written; the
   metric may be empty); ``text_localisation.main --random_img_path`` on a
   synthetic JPEG for phase 11's CLIP-RN50 students, pooled and
   attn-unpool, and phase 12's KD-trained attn-unpool student (K1 and K2
   through fast_clip, the .npz and .png; W GPU against CPU and against a
   float64 CPU pass under the GPU's ReLU gates within ten gated CPU
   spreads, and for phase 11's students also as phase 11 holds it); Ours
   on the ViT-B/16 of phase 13 in the -stride=112 mode over two grids (49
   crops of 224^2 each); each kernel against its plain version (both
   dtypes) and timed at the grid's shapes (Ours's and the gradient
   route's) beside its bound; K1, K2 and K3 in fp32 at every shape of one
   text localisation of the attn-unpool student, K1 at every shape of one
   ResNet-50 eval batch (64 images of 224^2) and K1 and K2 at every shape
   of one fp32 Ours grid (against their plain versions, then timed per
   call of the path with the card's busy time and the host's time per
   launch, beside their bounds in 3xTF32 at 495 TFLOP/s and at 67 TFLOP/s
   fp32, their plain versions and torch.matmul); the dtype of the
   activations that reached K1 in phase 9's validation and evaluate runs
   and in the localisation commands;
16. the CLIP benchmark harness (bcosification_tpu_torch/clip_benchmark, the
   port of the top-level clip_benchmark package) through its CLI in process
   (``cli.main([...])``, batch 64, fp32 images, so every encode runs K3's
   fp32 route) on phase 12's KD-trained CLIP-RN50 experiments (pooled,
   attn-unpool and the CC3M one) over seeded wds trees of 256^2 JPEGs:
   zero-shot classification (1024 images, the 1000 ImageNet classes x 80
   templates; the classifier built once with --save_clf, its tokenizer and
   text-tower seconds apart, and loaded with --load_clfs by the other runs)
   for bcos_clip pooled and attn-unpool, bcos_clip_cc3m and standard_clip
   RN50 (the vanilla tower, no K3); the linear probe
   on a separable 10-class colour set (2048 train, --val_proportion 0.2 and
   so the 7 + 4 x 3 weight-decay sweep, 1024 test; lp_acc1 >= 0.9), then
   again with --skip_load from the cached features; retrieval (512 images, 5
   captions each); caption selection (256 instances of 4 captions);
   captioning with bcos_captioner (a saved random head); text2concept_clip
   after fit_aligner and save_aligner; ``build`` over the ten JSONs. Per run:
   the JSON's keys (JAX's) and finite values, K3's launches per encode (36
   pooled, 37 attn-unpool; K1, K2 none), images/s, load seconds, encode
   seconds and host ms per batch. The zero-shot logits of 8 images and the
   probe head at weight decay 1e-4, GPU against CPU fp32, within ten CPU
   spreads under 1e-7 relative input noise; K3 against its plain version in
   fp32 at every distinct shape of one harness encode, and timed per
   attn-unpool fp32 encode beside its bounds (the 3xTF32 route's three
   tf32 products at 495 TFLOP/s; 67 TFLOP/s fp32 outside the tensor cores),
   plain version and torch.matmul, with tma_operands' count (0).

17. the B-cos v2 model zoo (models/pretrained.py): ``load_model`` of
   resnet50, densenet121 and simple_vit_l_patch16_224 (the from-scratch
   nets: BcosConv2d, the bias-free position norm, Identity, the logit layer
   inside; ViT-L/16: dim 1024, 14 encoders, 16 heads, mlp 4096) at full
   width, random init from SEED with no calibration (the norms renormalise
   every layer): K3 and K2 against their plain versions at eleven of their
   shapes in both dtypes (phase 3's bounds; K2 with the bare cotangent, the
   ViT's with the linear norm); per net, fp32 parity on 2 images of the
   hand-scheduled pass (fast_resnet's and fast_densenet's position-norm
   schedules, fast_vit), GPU against CPU (W within ten CPU spreads under
   1e-7 relative input noise, the CNNs with PyTorch's own CUDA convs, and
   within 1e-3 with cuDNN's; pre-logits 1e-4; the argmax identical) and the
   generic autograd W against it, with the pre-logit RMS; forward-only and
   fwd+explain images/s at batch 128, bf16 (ResNet-50 also through
   autograd), with their launch counts (K3 and K2 at every stride-1 1x1
   B-cos conv and bias-free B-cos linear, no K1); each kernel's time at
   every shape one fwd+explain gave it, beside its bound, plain version and
   torch.matmul; the export_explain round trip at a cut depth (the first
   two stages at full width: one bottleneck each, the DenseNet-121 two
   dense layers and one; the ViT-L's fast_vit
   program is phase 14's) against the eager pass; then load_model of the
   ResNet-50 and the DenseNet-121 from npz
   files of the JAX export format written to a temporary BCOS_WEIGHTS_DIR,
   and convert_release_checkpoint of seeded reference-layout .pth files of
   resnet50 in both released flavours: the position-norm one equal to its
   source, the uncentered-BN one rebuilt with BatchNormUncentered2d, its
   forward on K1 at the 36 1x1s, its fast pass on K1, K2 and K3.
18. the zoo's VGG and ConvNeXt entries (models/vgg.py, models/convnext.py):
   K3 and K2 against their plain versions at thirteen of their shapes in
   both dtypes (ConvNeXt-T's stages and classifier, ConvNeXt-atto's K and
   N of 40 and 160, ConvNeXt-B's first stage, VGG-16's two 1x1 classifier
   convs; phase 3's bounds; no operand padded); the plain vgg16's
   per-layer output RMS (random init contracts ~1/sqrt(9 Cin) per conv);
   then ``load_model`` of vgg16_bnu, convnext_tiny and convnext_base_bnu at
   full width, random init from SEED, each ConvNeXt block's layer_scale
   drawn in +-[0.1, 1] and each uncentered BN's gamma calibrated (its
   output RMS 1, the last one's the pre-logits'): phase 17's per-net
   checks (launches K3 2 / 37 / 73 per forward and K2 as many per
   explanation, no K1; fp32 parity on 2 images of explain/fast_vgg.py and
   explain/fast_convnext.py, GPU against CPU within ten CPU spreads with
   PyTorch's own CUDA convs and 1e-3 with cuDNN's, and the generic W
   against them; forward-only and fwd+explain images/s at batch 128, bf16,
   with the card's busy time and top kernels; K3's and K2's time at every
   shape one fwd+explain gave them; the export_explain round trip of
   convnext_base_bnu cut to its first two stages, one block each); then
   convert_release_checkpoint of seeded reference-layout .pth files of
   vgg16_bnu, convnext_tiny and convnext_tiny_bnu (the last under the name
   convnext_tiny, its running statistics rebuilding it with uncentered BN),
   each equal to its source;
19. the training options no grid config sets, on the resnet_50 recipe's
   bcosified ResNet-50 at full width (phase 4's weights and calibrated BN
   statistics, a learnable b at its initial value): Trainer.fit with accumulate_grad_batches 2 over 4
   micro-batches of 64 (bf16 amp) with the TensorBoard logger at every
   step, --profile_dir, --debug and explanation logging (launches: K3 34
   per micro-batch, each validation's forward, the explanation logger's
   fast pass 36 / 37 / 1), the event file read back with its CRCs, the
   npz and PNG of the explanations, the profiler trace's CUDA kernels and
   the printed parameter hash; the accumulated step alone (K3 68 per
   optimizer step, the parameters unchanged after the first micro-batch,
   its time and card busy time) and, on the small flagship in fp32, Adam's
   first moment after one accumulated update on the GPU against the CPU
   within ten CPU spreads; Trainer.fit of 3 steps at batch 64 of each
   learnable-b variant (learn_b; clamping with manual_optim, its SGD at lr
   0.05; clamping with linear_b), then 3 more steps and the module-path
   explanation of 8 images, with no launch of K1, K2 or K3 and the fast
   pass refusing the net, the stem conv's b after each step (linear_b's
   equal to make_linear_b_schedule in f32) and the step's time and card
   busy time; the clip_kd ResNet-50 (CLIP's Normalize constants) in fp32
   on 2 images, its pre-logits against the CPU's within 1e-4; then K1, K2
   and K3 in fp32 at every shape of one explanation logger call (8 images
   of 224^2 through fast_resnet: 36 / 37 / 1 launches), each against its
   plain version and timed per call beside its bounds, plain version and
   torch.matmul, with the card's busy time;
20. the CLIP ViT towers (ROADMAP A6): the B-cosified ViT-B/16 students of
   the clip_bcosification recipe, pooled and attn-unpool (width 768, 12
   blocks, 12 heads, patch 16, 197 tokens, embed_dim 512; random init from
   SEED): K3 and K2 against their plain versions at the distinct shapes
   of one encode at batch 128 (M = 25 216) and one KD step at batch 64 (M =
   12 608) in both dtypes (phase 3's bounds; the linear norm, K2 with the
   bare cotangent); per head, fp32 on 2 images, GPU against CPU, the
   features, W of the text explanation from explain/fast_clip_vit.py and
   from the module path through autograd, and the two paths against each
   other (each within ten times the CPU's own spread under 1e-7 relative
   input noise, the patchify conv on PyTorch's own CUDA conv; with cuDNN's
   within 1e-3); the attn-unpool head's encode and text fwd+explain
   images/s at batch 128 from bf16 images (launches K3 36 per encode, K3 36 and K2 36
   per explanation, no K1; host issue time, peak memory, card busy time
   and top kernels); export_text_explain of the attn-unpool student at
   depth 2, loaded from bytes and held to the eager pass; Trainer.fit of
   the attn-unpool ViT-B/16 KD Experiment for 5 steps at batch 64, bf16
   amp, with the random-init ViT-B/16 teacher (finite losses, K3 36 per
   step, the teacher equal to a fresh load, the student moved) and the KD
   step's ms and img/s over a window; the dtypes that reach the B-cos
   linears (f32 from the first block's q/k/v projection on: its bias, zeroed
   in the student, promotes, as in the JAX package), then K3 and K2 in
   that dtype at every shape of one encode, one explanation and one KD
   step beside their bounds, plain versions and torch.matmul. Phase 16 also runs ``cli eval
   --model_type standard_clip --model ViT-B-32`` (zero-shot, the plain ViT
   tower at random init: no K3) on its tree;
21. (a) the switch-MoE ViT-B/16 (ROADMAP A7: ``simple_vit_b_patch16_224``
   with 8 experts in every feed-forward, capacity factor 1.25, BcosLinear,
   6 channels, random init from SEED) at top-1 and top-2 on the same
   weights: K3 and K2 against their plain versions at the experts' shapes
   (C = 3920 and 7840 slots, K 3072, N 768) in both dtypes; per top-k, fp32
   on 2 images: the fast pass on the CPU records its routing, the fast
   pass and the module path on the GPU run under it (the decisions that
   differ, and their largest probability margin, against ten times the
   CPU's spread of the router's probabilities under 1e-7 relative input
   noise; W within ten CPU spreads, pre-logits 1e-4, argmax identical),
   and x . W equals the selected logit without the positional embedding
   (1e-4); forward-only and fast-pass fwd+explain images/s at batch 128,
   bf16, with launches (K3 122 per forward: 8 per MoE; K2 122 per
   explanation), card busy time and top kernels; K3 and K2 timed at every
   shape of one fwd+explain; the top-2 net at depth 1 exported (forward and
   explanation), loaded and held to the eager calls; its recipe train step
   at batch 64 (K3 122). (b)
   BCOS_INT8=1 serving (ROADMAP A8) of phase 4's ResNet-50 at batch 128,
   bf16, the flag set for this part only: launches (K1 at layer1's 7 1x1s,
   no K3: the classifier is quantized) and one int8 product per quantized
   conv (43); forward-only images/s and card busy time, bf16 and int8; the card's int32 products (torch._int_mm) of one image equal to
   the CPU's plain float64 conv at every quantized shape; the pre-logits
   against bf16 (rel L2 within INT8_PRELOGIT_BOUND) and the top-1
   agreement; a backward through a quantized conv raises; export_forward
   under the flag of the net cut to its first two stages, one bottleneck
   each, loaded with the flag unset,
   equal to the eager int8 forward; the int8 route at each quantized 1x1
   (quantize, torch._int_mm, dequantize) beside torch._int_mm alone, its
   bound at 1979 TOP/s and the bf16 K1 or K3 it replaces; K1 timed at
   layer1's shapes.

``python3 chip_smoke.py --fp32-routes`` builds the kernels and prints only
the fp32 routes' rows of phases 15 and 16 (random-init nets, seeded
operands), the text localisation's rows four times (split-K, 128 x 128
tiles alone, tiles, split-K), so that two trees' kernels, or the two
tilings, can be timed in one call.

Every time is taken over runs of calls in a row between two CUDA events, so
the host's launch of one call overlaps the card's work on the one before:
a kernel's time is the median of 10 runs of 10 launches, a whole-model rate
is the images of one window of about 1.7 s over its time. No operand of a
ResNet-50, DenseNet-121, CLIP-RN50, ViT-B/16, ViT-C, analysis, harness,
zoo, VGG, ConvNeXt, CLIP ViT, MoE ViT or int8 path, bf16 or fp32, needs
the TMA padding (``tma_operands.padded`` stays 0 after phase 3: the CLIP
ViT's M = 197 B and an expert's slots are no multiple of 128, but only K,
the rows' length, must lie on the grid).
The last three lines are the card, one JSON object with the kernels'
numbers, and {"ok": true, "device": {...}}.
Without a GPU, or without the repository next to it, the script exits
non-zero and prints no result.
"""
import collections
import contextlib
import copy
import hashlib
import importlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

from bcosification_tpu_torch import evaluate as evaluate_cli
from bcosification_tpu_torch import serving, settings
from bcosification_tpu_torch import train as train_cli
from bcosification_tpu_torch.data.synthetic import write_cc3m_tree, write_imagenet_tree
from bcosification_tpu_torch.experiments.utils.experiment_utils import Experiment
from bcosification_tpu_torch.losses import (
    BinaryCrossEntropyLoss,
    UniformOffLabelsBCEWithLogitsLoss,
)
from bcosification_tpu_torch.optim import LRSchedulerFactory, OptimizerFactory
from bcosification_tpu_torch.training import kd as kd_lib
from bcosification_tpu_torch.training import steps as steps_lib
from bcosification_tpu_torch.training import zeroshot
from bcosification_tpu_torch.training.trainer import Trainer
from bcosification_tpu_torch.bcosify import release_import
from bcosification_tpu_torch.bcosify.clip_import import build_clip_teacher_visual, build_clip_text
from bcosification_tpu_torch.bcosify.engine import (
    build_bcosified_densenet,
    build_bcosified_resnet,
    build_bcosified_vit,
)
from bcosification_tpu_torch.clip.model import ModifiedResNet, clip_rn50_config
from bcosification_tpu_torch.clip.tokenizer import tokenize
from bcosification_tpu_torch.data.imagenet import imagenet_classes, imagenet_templates
from bcosification_tpu_torch.bcosify.from_jax import to_jax_variables
from bcosification_tpu_torch.explain import (
    fast_clip,
    fast_convnext,
    fast_densenet,
    fast_resnet,
    fast_vgg,
    fast_vit,
)
from bcosification_tpu_torch.explain.core import dynamic_linear_weights, explain
from bcosification_tpu_torch.explain.fast_resnet import fast_dynamic_linear_weights
from bcosification_tpu_torch.models import convnext, pretrained, resnet
from bcosification_tpu_torch.models.bcosify_net import BcosifyNetwork
from bcosification_tpu_torch.models.densenet import DENSENET_CONFIGS, BcosDenseNet
from bcosification_tpu_torch.models.resnet import Bottleneck
from bcosification_tpu_torch.models import vit as vit_models
from bcosification_tpu_torch.models.vit import VIT_CONFIGS
from bcosification_tpu_torch.modules import (
    BatchNormUncentered2d,
    BcosConv2d,
    BcosLinear,
    NoBias,
    ReLU,
)
from bcosification_tpu_torch.modules.moe import BcosMoE, record_intermediates
from bcosification_tpu_torch.ops import bcos as bcos_ops
from bcosification_tpu_torch.ops import int8 as int8_ops
from bcosification_tpu_torch.ops.bcos import LINEAR_NORM_EPS
from bcosification_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
from bcosification_tpu_torch.ops.cuda import bcos_conv1x1 as k12
from bcosification_tpu_torch.ops.cuda import bcos_matmul as k3
from bcosification_tpu_torch.ops.cuda import stream as k4
from bcosification_tpu_torch.probes import stream_bandwidth
from bcosification_tpu_torch.utils.init_mode import abstract_init

FLAGSHIP = {
    "name": "resnet50",
    "bcosify_args": {"fix_b": True, "use_bias": False, "norm_layer": "BnUncV2",
                     "gap": True, "act_layer": True},
    "bcos_args": {"b": 2},
}
BATCH, SIZE, SEED = 128, 224, 0
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12   # H100 SXM float32 outside the tensor cores (data sheet)
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense tf32 (data sheet); 3xTF32 does 3 tf32 products
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SOURCES = {
    "bcos_conv1x1_fwd": ("bcosification_tpu_torch/ops/cuda/csrc/bcos_conv1x1_fwd.cu",
                         "bcosification_tpu/ops/pallas/bcos_conv1x1.py:85"),
    "bcos_conv1x1_bwd_explain": ("bcosification_tpu_torch/ops/cuda/csrc/bcos_conv1x1_bwd.cu",
                                 "bcosification_tpu/ops/pallas/bcos_conv1x1.py:124"),
    "bcos_matmul_fwd": ("bcosification_tpu_torch/ops/cuda/csrc/bcos_matmul_fwd.cu",
                        "bcosification_tpu/ops/pallas/bcos_matmul.py:45"),
    "stream_add": ("bcosification_tpu_torch/ops/cuda/csrc/stream_add.cu",
                   "scripts/perf_probe9.py:22"),
}
MODEL_KERNELS = ("bcos_conv1x1_fwd", "bcos_conv1x1_bwd_explain", "bcos_matmul_fwd")
PROBE_M, PROBE_C, PROBE_NIN = 401408, 256, 3  # the layer1 activation at batch 128
SERVE_EVERY = 10  # the mixed loop explains 1 batch in SERVE_EVERY
# calls per timing window: each window holds about 1.7 s of the card's work
# on an H100 at batch 128 (23 ms forward, 42 ms fwd+explain, 237 ms period)
WINDOW_FWD, WINDOW_EXPLAIN, WINDOW_PERIODS = 72, 40, 7
CHECK_SHAPES = [  # (label, M, Cin, Cout, relu) at batch 128, 224x224
    ("layer1.conv1", 401408, 256, 64, True),
    ("layer1.conv3", 401408, 64, 256, False),
    ("layer3.conv3", 25088, 256, 1024, False),
    ("layer4.conv3", 6272, 512, 2048, False),
    ("layer4.downsample(s2)", 6272, 1024, 2048, False),
    ("classifier", 6272, 2048, 1000, False),
    # DenseNet-121's conv1 widths (phase 10): Cout 128 beside a deep Cin
    ("densenet b1.l6.conv1", 401408, 224, 128, True),
    ("densenet b3.l24.conv1", 25088, 992, 128, True),
]
# K3's train-step shapes at batch 64, 224x224 (label, M, K, N): N = 64 is
# below one 128-wide tile, K = 64 one K step of the engine
TRAIN_CHECK_SHAPES = [
    ("train layer1.conv1", 200704, 64, 64),
    ("train layer1.conv3", 200704, 64, 256),
    ("train layer4.conv1", 3136, 2048, 512),
    ("train layer4.conv3", 3136, 512, 2048),
    ("train classifier", 3136, 2048, 1000),
]
# fp32 shapes off the TMA grid and the tiles (label, M, K, N, relu,
# misaligned x): M = 49 (layer4 of one 224^2 image) and 3136 + 13, N = 1000
# and N % 4 != 0, K % 4 != 0 and a deep K, one x 4 bytes off the 16-byte
# grid. tma_operands pads or realigns the operands there (two K1, one K2
# and two K3 calls per such shape). On an H100's 132 SMs K1, K2's g and K3
# run split-K at M = 49 (16 splits at K = 2046)
FP32_RAGGED_SHAPES = [
    ("ragged m49 k30 n1000", 49, 30, 1000, True, False),
    ("ragged m3149 k64 n130", 3149, 64, 130, False, False),
    ("ragged m49 k2046 n61", 49, 2046, 61, True, False),
    ("ragged m3149 k1022 n1001", 3149, 1022, 1001, False, False),
    ("misaligned m49 k64 n1000", 49, 64, 1000, True, True),
]
# each kernel's earlier ms per fwd+explain call (PERF.md; NVIDIA H100 80GB
# HBM3, 700.00 W), timed by the same method as time_kernels
PREVIOUS_MS = {"bcos_conv1x1_fwd": ("PR 3", 5.32), "bcos_conv1x1_bwd_explain": ("PR 3", 7.61),
               "bcos_matmul_fwd": ("PR 3", 0.507)}
CARD = ""


def say(*parts):
    print(*parts, flush=True)


# --------------------------------------------------------------------------
# 1-2: device and build
# --------------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    _build.load()
    say(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


# --------------------------------------------------------------------------
# 3: kernels
# --------------------------------------------------------------------------
def operands(m, k, n, dtype, gen):
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    wt = (torch.randn(n, k, device="cuda", generator=gen) / math.sqrt(k)).to(dtype)
    mult = torch.rand(n, device="cuda", generator=gen) + 0.5
    add = 0.1 * torch.randn(n, device="cuda", generator=gen)
    ct = torch.randn(m, n, device="cuda", generator=gen).to(dtype)
    return x, wt, mult, add, ct


def kernel_calls(name, x, wt, mult, add, ct, relu, eps_outside=False):
    """(kernel call, plain call, torch.matmul call) for one launch's work;
    ``eps_outside``: a B-cos linear's (the linear norm, no BN's mult)."""
    if name == "bcos_conv1x1_fwd":
        return (lambda: k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                lambda: k12.conv1x1_fwd_plain(x, wt, mult, add, relu=relu),
                lambda: torch.matmul(x, wt.t()))
    eps = LINEAR_NORM_EPS if eps_outside else 1e-6
    if name == "bcos_conv1x1_bwd_explain":
        a = k12.conv1x1_fwd(x, wt, mult, add, relu=True) if relu else None
        mu = None if eps_outside else mult
        kw = dict(relu=relu, eps=eps, eps_outside=eps_outside)
        return (lambda: k12.conv1x1_bwd_explain(x, wt, ct, a, mu, **kw),
                lambda: k12.conv1x1_bwd_explain_plain(x, wt, ct, a, mu, **kw),
                lambda: torch.matmul(torch.matmul(x, wt.t()), wt))
    return (lambda: k3.bcos_matmul_fwd(x, wt, eps=eps, eps_outside=eps_outside),
            lambda: k3.bcos_matmul_fwd_plain(x, wt, eps=eps, eps_outside=eps_outside),
            lambda: torch.matmul(x, wt.t()))


def _check(worst, name, variant, label, dtype, got, want):
    """Hold one kernel result against its plain version (see phase 3)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.float32:
        err, bound = float(diff.max() / want.abs().max()), 1e-5
    else:
        err, bound = float((got - want).norm() / want.norm()), 1e-2
    worst[name] = max(worst[name], float(diff.max()))
    ok = err <= bound and bool(torch.isfinite(got).all())
    say(f"check {name + variant:28s} {label:22s} {str(dtype)[6:]:8s} "
        f"rel err {err:.3e} (bound {bound:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at {label}")


def _k3_results(x, wt, ref):
    return [("bcos_matmul_fwd", " eps_outside" if eps_outside else "",
             k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=eps_outside),
             k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=1e-6, eps_outside=eps_outside))
            for eps_outside in (False, True)]


def check_kernels():
    """Each kernel against its plain version at the six check shapes, both
    dtypes (K3 with both eps_outside values), and K3 also at the train
    step's shapes. Returns {kernel: max abs error over all checks}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {name: 0.0 for name in MODEL_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for label, m, k, n, relu in CHECK_SHAPES:
            x, wt, mult, add, ct = operands(m, k, n, dtype, gen)
            a = k12.conv1x1_fwd(x, wt, mult, add, relu=True)
            results = [  # (kernel, variant, kernel's result, plain version's)
                ("bcos_conv1x1_fwd", "", k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                 k12.conv1x1_fwd_plain(ref(x), ref(wt), mult, add, relu=relu)),
                ("bcos_conv1x1_bwd_explain", "",
                 k12.conv1x1_bwd_explain(x, wt, ct, a, mult, relu=relu),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), ref(a), mult,
                                               relu=relu)),
            ] + _k3_results(x, wt, ref)
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, label, dtype, got, want)
            del x, wt, ct, a, results
        for label, m, k, n in TRAIN_CHECK_SHAPES:
            x, wt, *_ = operands(m, k, n, dtype, gen)
            results = _k3_results(x, wt, ref)
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, label, dtype, got, want)
            del x, wt, results
    padded = k12.tma_operands.padded
    for label, m, k, n, relu, misaligned in FP32_RAGGED_SHAPES:
        x, wt, mult, add, ct = operands(m, k, n, torch.float32, gen)
        if misaligned:  # the same values at a data pointer 4 bytes off the grid
            x = torch.empty(m * k + 1, device="cuda")[1:].view(m, k).copy_(x)
        a = k12.conv1x1_fwd(x, wt, mult, add, relu=True)
        results = [("bcos_conv1x1_fwd", "", k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                    k12.conv1x1_fwd_plain(x, wt, mult, add, relu=relu)),
                   ("bcos_conv1x1_bwd_explain", "",
                    k12.conv1x1_bwd_explain(x, wt, ct, a, mult, relu=relu),
                    k12.conv1x1_bwd_explain_plain(x, wt, ct, a, mult, relu=relu))]
        results += _k3_results(x, wt, lambda t: t)
        torch.cuda.synchronize()
        for name, variant, got, want in results:
            _check(worst, name, variant, label, torch.float32, got, want)
        del x, wt, ct, a, results
    padded = k12.tma_operands.padded - padded
    want = 5 * sum(k % 4 != 0 or mis for _, _, k, _, _, mis in FP32_RAGGED_SHAPES)
    say(f"check fp32 ragged shapes: tma_operands padded or realigned {padded} calls "
        f"(expected {want})")
    if padded != want:
        raise AssertionError(f"the fp32 ragged checks padded {padded} calls, expected {want}")
    k12.tma_operands.padded = 0  # the main paths' count starts here
    return worst


def conv1x1_shapes(model, batch, size):
    """([(M, K, N, relu, stride)] of the trunk's 1x1 convs in forward order:
    conv1, conv3 and the downsample of each bottleneck; (M, K, N) of the
    classifier) at this batch and input size."""
    s = ((size + 6 - 7) // 2 + 1 + 2 - 3) // 2 + 1  # 7x7/s2/p3 conv, 3x3/s2/p1 pool
    convs = []
    for stage, j, planes, stride, has_ds in model.block_cfgs():
        cin = model.block_in(stage, j)
        s_out = (s - 1) // stride + 1
        convs += [(batch * s * s, cin, planes, True, 1),
                  (batch * s_out * s_out, planes, 4 * planes, False, 1)]
        if has_ds:
            convs.append((batch * s_out * s_out, cin, 4 * planes, False, stride))
        s = s_out
    return convs, (batch * s * s, model.block_in(len(model.layers), 0), model.num_classes)


def main_path_launches(model, batch, size):
    """[(kernel, M, K, N, relu)] for every kernel launch of one fast
    forward + explanation call at this batch and input size."""
    convs, (m, k, n) = conv1x1_shapes(model, batch, size)
    launches = []
    for cm, ck, cn, relu, _ in convs:
        launches += [("bcos_conv1x1_fwd", cm, ck, cn, relu),
                     ("bcos_conv1x1_bwd_explain", cm, ck, cn, relu)]
    return launches + [("bcos_matmul_fwd", m, k, n, False),
                       ("bcos_conv1x1_bwd_explain", m, k, n, False)]


def bound_terms(name, m, k, n, relu, dtype=torch.bfloat16):
    """(FLOPs, bytes) of the least work one launch must do with operands of
    ``dtype``: each input read once, each output written once."""
    e = torch.finfo(dtype).bits // 8  # bytes per operand element
    if name == "bcos_conv1x1_fwd":
        flops, nbytes = 2 * m * k * n, e * (m * k + n * k + m * n) + 8 * n
    elif name == "bcos_conv1x1_bwd_explain":
        # u = x wt^T recomputed, then dx = g wt: two GEMMs of the same size
        flops = 4 * m * k * n
        nbytes = e * (2 * m * k + n * k + m * n * (2 if relu else 1)) + 4 * n
    else:
        flops, nbytes = 2 * m * k * n, e * (m * k + n * k) + 4 * m * n
    return flops, nbytes


def time_shapes(per_shape, stream_rate, gen, tag="", dtype=torch.bfloat16):
    """{kernel: row} over ``per_shape`` {(kernel, M, K, N, relu[,
    eps_outside]): launches}:
    each distinct shape timed in ``dtype`` (bf16, or fp32 with TF32 off) as
    the median of 10 samples of 10 launches in a row (the plain version 3
    samples of 3), weighted by its launches. A row sums ms, plain_ms,
    library_ms (torch.matmul), the bound at the data-sheet rates (bound_s,
    split into flop_s and byte_s by what binds; fp32 FLOPs on the route the
    kernels run, 3xTF32: three tf32 products at 495 TFLOP/s) and at
    ``stream_rate`` (bytes/s, K4's measured rate on this card), the FLOPs,
    and the fp32 bound at the 67 TFLOP/s outside the tensor cores
    (cores_s, a side column; ``fp32_cores_ms``)."""
    peak_flops = PEAK_TF32_FLOPS / 3 if dtype == torch.float32 else PEAK_BF16_FLOPS
    rows = {}
    for (name, m, k, n, relu, *linear), count in sorted(per_shape.items()):
        x, wt, mult, add, ct = operands(m, k, n, dtype, gen)
        kern, plain, lib = kernel_calls(name, x, wt, mult, add, ct, relu, any(linear))
        t_k = stream_bandwidth.event_ms(kern, 10)
        t_p = stream_bandwidth.event_ms(plain, 3, warmup=1, burst=3)
        t_l = stream_bandwidth.event_ms(lib, 10)
        flops, nbytes = bound_terms(name, m, k, n, relu, dtype)
        f_s, b_s = flops / peak_flops, nbytes / PEAK_BYTES
        r = rows.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flop_s=0.0,
                                       byte_s=0.0, bound_s=0.0, measured_bound_s=0.0,
                                       flops=0.0, cores_s=0.0))
        r["ms"] += count * t_k
        r["flops"] += count * flops
        r["plain_ms"] += count * t_p
        r["library_ms"] += count * t_l
        r["bound_s"] += count * max(f_s, b_s)
        r["measured_bound_s"] += count * max(f_s, b_s * PEAK_BYTES / stream_rate)
        r["cores_s"] += count * max(flops / PEAK_FP32_FLOPS, b_s)
        r["flop_s" if f_s >= b_s else "byte_s"] += count * max(f_s, b_s)
        label = name + (" linear" if any(linear) else "")
        say(f"time {tag}{label:26s} M={m:6d} K={k:4d} N={n:4d} x{count:2d}: {t_k:.4f} ms, "
            f"{flops / t_k / 1e9:.1f} TFLOP/s, {nbytes / t_k / 1e6:.1f} GB/s "
            f"(bound {1e3 * max(f_s, b_s):.4f} ms by {'FLOPs' if f_s >= b_s else 'bytes'}, "
            f"{1e3 * max(f_s, b_s * PEAK_BYTES / stream_rate):.4f} ms at the measured rate; "
            f"plain {t_p:.4f}, torch.matmul {t_l:.4f}) [{CARD}]")
        del x, wt, ct
    return rows


def check_bounds(kernels):
    """Every time in the kernels line at or above its data-sheet bound
    (``ms`` against ``bound_ms``, ``<path>_ms`` against ``<path>_bound_ms``):
    a kernel faster than its bound means the bound took a lower peak rate
    than the card has for that work."""
    below = [f"{row['name']} {key[:-len('bound_ms')]}ms {row[key[:-len('bound_ms')] + 'ms']:.4f}"
             f" < {bound:.4f}"
             for row in kernels for key, bound in row.items()
             if (key == "bound_ms" or key.endswith("_bound_ms")) and bound is not None
             and row.get(key[:-len("bound_ms")] + "ms", bound) < bound]
    if below:
        raise AssertionError("kernel times below their bounds: " + "; ".join(below))
    say("every kernel time in the kernels line is at or above its data-sheet bound")


def fp32_cores_ms(row):
    """A row's fp32 bound outside the tensor cores (67 TFLOP/s, 3350 GB/s):
    a side column beside bound_s, which is on the 3xTF32 route they run."""
    return 1e3 * row["cores_s"]


def time_kernels(model, worst, counts, stream_rate):
    """Per kernel: time, bound, plain and torch.matmul time of ONE main-path
    call's launches (bf16, batch 128; ``time_shapes``)."""
    per_shape = collections.Counter(main_path_launches(model, BATCH, SIZE))
    for name in MODEL_KERNELS:
        expected = sum(c for key, c in per_shape.items() if key[0] == name)
        if counts.get(name) != expected:
            raise AssertionError(f"{name}: {counts.get(name)} launches, shapes list {expected}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = time_shapes(per_shape, stream_rate, gen)
    kernels = []
    for name in MODEL_KERNELS:
        r = rows[name]
        pr, before = PREVIOUS_MS[name]
        say(f"{name} per call: {r['ms']:.4f} ms ({pr}: {before:g} ms); bound "
            f"{1e3 * r['bound_s']:.4f} ms at the 3350 GB/s data sheet rate, "
            f"{1e3 * r['measured_bound_s']:.4f} ms at the measured "
            f"{stream_rate / 1e9:.1f} GB/s; plain {r['plain_ms']:.4f} ms, torch.matmul "
            f"{r['library_ms']:.4f} ms [{CARD}]")
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": worst[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": 1e3 * r["bound_s"],
            "bound_by": "operations" if r["flop_s"] >= r["byte_s"] else "bytes",
            "library_ms": r["library_ms"],
        })
    return kernels


# --------------------------------------------------------------------------
# 4: full-width parity
# --------------------------------------------------------------------------
def _output_rms(net, probe, module, transform=None):
    """RMS of ``module``'s output (or of transform(output)) in net(probe)."""
    seen = []
    hook = module.register_forward_hook(
        lambda mod, args, out: seen.append(out if transform is None else transform(out)))
    try:
        with torch.no_grad():
            net(probe)
    finally:
        hook.remove()
    return float(seen[0].double().pow(2).mean().sqrt())


def calibration_steps(m):
    """[(BN, module, transform)] of ``calibrate`` in forward order: each BN
    gamma is divided by the RMS of ``module``'s output (or transform(it))."""
    if isinstance(m, ModifiedResNet):  # CLIP: every norm runs apart from its conv
        steps = [(bn, bn, None) for _, bn, _, _ in m.stem()]
        for blk in m.blocks():
            steps += [(blk.bn1, blk.bn1, None), (blk.bn2, blk.bn2, None),
                      (blk.bn3, blk.bn3, None)]
            if blk.has_downsample:
                steps.append((blk.downsample_norm, blk.downsample_norm, None))
        return steps
    if isinstance(m, BcosDenseNet):
        # pre-activation: each norm's gamma scales the conv after it (b=2
        # convs are homogeneous of degree 1), and a concat keeps the older
        # features as they are, so only the new ones are rescaled
        steps = [(m.norm0, m.norm0, None)]
        for i in range(len(m.block_config)):
            for layer in m.dense_layers(i):
                steps += [(layer.norm1, layer.conv1, None), (layer.norm2, layer.conv2, None)]
            if m.transition(i) is not None:
                steps.append((m.transition(i).norm, m.transition(i).conv, None))
        return steps + [(m.norm5, m.classifier, None)]
    steps = [(m.bn1, m.bn1, None)]
    for blk in m.blocks():
        if isinstance(blk, Bottleneck):
            def y3(c2, blk=blk):  # conv3's segment without the skip-add and ReLU
                mult, add = blk.bn3(None, return_affine=True)
                return blk.conv3(c2, explain=True, epilogue=(mult, add, False))

            steps += [(blk.bn1, blk.conv1, None), (blk.bn2, blk.bn2, None),
                      (blk.bn3, blk.act2, y3)]
        else:  # BasicBlock: both 3x3 norms run unfolded
            steps += [(blk.bn1, blk.bn1, None), (blk.bn2, blk.bn2, None)]
        if hasattr(blk, "downsample_norm"):
            steps.append((blk.downsample_norm, blk.downsample_conv, None))
    return steps


def calibrate(net, probe):
    """Scale each BN gamma, in forward order, so that its segment's output
    (ResNet), the conv after it (DenseNet) or the norm's own output (CLIP)
    has RMS 1 on ``probe``: a random-init b=2 net contracts to ~1e-20 and
    makes every comparison vacuous. A uniform factor on all gammas does not
    work at full depth: the early layers overflow before the output reaches
    O(1). Returns the pre-logit magnitude (a CLIP tower's feature
    magnitude) afterwards."""
    bias = net.logit_bias if net.with_logit_layer else 0.0
    with torch.no_grad():
        for bn, module, transform in calibration_steps(net.model):
            bn.weight.div_(_output_rms(net, probe, module, transform))
        mag = float((net(probe).double() - bias).abs().max())
    if not 1e-4 < mag < 1e4:
        raise AssertionError(f"gamma calibration failed: pre-logit magnitude {mag}")
    return mag


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def phase_parity(net, x2):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lg, sg, wg = fast_dynamic_linear_weights(net, x2)
    lm, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x2)
    cpu_net = copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    lc, sc, wc = fast_dynamic_linear_weights(cpu_net, x2.cpu(), device="cpu")
    cpu_s = time.perf_counter() - t0
    # the conditioning: how far fp32-rounding-sized input noise moves W on the CPU
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED))
    _, _, wn = fast_dynamic_linear_weights(cpu_net, x2.cpu() * (1 + 1e-7 * noise),
                                           device="cpu")
    say(f"parity W on the cpu under 1e-7 relative input noise: {rel(wn, wc):.3e}")
    bias = net.logit_bias
    pre_err = float(((lg.double().cpu() - bias) - (lc.double() - bias)).abs().max()
                    / (lc.double() - bias).abs().max())
    # (value, bound). Across devices every conv sums in another order, and
    # at full depth W is ill-conditioned in those roundings: on the CPU alone
    # a 1e-7 relative input perturbation moves W by ~6e-5 (PERF.md), so the
    # GPU-vs-CPU bound on W is 1e-3. Within one device the two paths share
    # their convs and are held to 1e-4.
    checks = {
        "W gpu-kernels vs cpu-plain": (rel(wg, wc), 1e-3),
        "W module-path vs fast-path (gpu)": (rel(wm, wg), 1e-4),
        "pre-logit gpu vs cpu (max rel)": (pre_err, 1e-4),
        "pre-logit module vs fast (max rel)": (float(
            (lm.double() - lg.double()).abs().max() / (lg.double() - bias).abs().max()), 1e-4),
    }
    for key, (val, bound) in checks.items():
        say(f"parity {key}: {val:.3e} (bound {bound:.0e})")
    same_sel = bool((sg.cpu() == sc).all() and (sm == sg).all())
    say(f"parity argmax identical: {same_sel}; cpu plain pass took {cpu_s:.1f} s")
    if not same_sel or any(val > bound for val, bound in checks.values()):
        raise AssertionError("full-width parity failed")
    if not all(torch.isfinite(t).all() for t in (lg, wg)) or wg.shape != x2.shape:
        raise AssertionError("full-width outputs are not finite or mis-shaped")


# --------------------------------------------------------------------------
# 5: throughput
# --------------------------------------------------------------------------
EXPLAIN_COUNTS = {"bcos_conv1x1_fwd": 36, "bcos_conv1x1_bwd_explain": 37,
                  "bcos_matmul_fwd": 1, "stream_add": 0}
FORWARD_COUNTS = {"bcos_conv1x1_fwd": 36, "bcos_conv1x1_bwd_explain": 0,
                  "bcos_matmul_fwd": 1, "stream_add": 0}


def check_counts(what, counts, expected):
    if counts != expected:
        raise AssertionError(f"{what} launches {counts}, expected {expected}")


def window_ms(fn, calls, warmup=1):
    """Milliseconds per call of ``calls`` calls of ``fn`` in a row between
    two CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def timed_iters(fn, iters):
    """(median, all) CUDA-event ms of ``iters`` single calls, and the median
    host ms to issue one call (the Python call's return, before the card
    finishes): while it stays below the card's time, the launches' host
    cost, custom-op dispatch included, is hidden."""
    fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times, statistics.median(host)


def phase_throughput(net, x2):
    """bf16 batch of 128 whose first two images are x2 (rounded to bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.rand((BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    x = torch.cat([x, 1.0 - x], dim=-1)
    x[:2] = x2
    x = x.to(torch.bfloat16)

    def explain_call():
        return fast_dynamic_linear_weights(net, x)

    def forward_call():
        with torch.no_grad():
            return net(x)

    explain_call()
    torch.cuda.synchronize()
    reset_launch_counts()
    logits, sel, w = explain_call()
    torch.cuda.synchronize()
    counts_explain = launch_counts()
    reset_launch_counts()
    forward_call()
    torch.cuda.synchronize()
    counts_forward = launch_counts()
    say(f"launches per fwd+explain call: {counts_explain}; per forward: {counts_forward}")
    check_counts("fwd+explain", counts_explain, EXPLAIN_COUNTS)
    check_counts("forward", counts_forward, FORWARD_COUNTS)
    if not (torch.isfinite(logits).all() and torch.isfinite(w).all()) or w.shape != x.shape:
        raise AssertionError("bf16 outputs are not finite or mis-shaped")
    # bf16 against fp32 on the same (rounded) two images, for the record: at
    # full depth W is ill-conditioned in the roundings (see phase_parity), so
    # bf16 rounding moves it far more than fp32 rounding does
    l_ref, _, w_ref = fast_dynamic_linear_weights(net, x[:2].float())
    pre = (logits[:2].double() - net.logit_bias, l_ref.double() - net.logit_bias)
    say(f"bf16 vs fp32 on the first two images: W rel {rel(w[:2].float(), w_ref):.3e}, "
        f"pre-logit max rel {float((pre[0] - pre[1]).abs().max() / pre[1].abs().max()):.3e}")
    torch.cuda.reset_peak_memory_stats()
    ms_explain = window_ms(explain_call, WINDOW_EXPLAIN)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms_forward = window_ms(forward_call, WINDOW_FWD)
    single_explain, all_explain, host_explain = timed_iters(explain_call, 10)
    single_forward, all_forward, host_forward = timed_iters(forward_call, 10)
    say(f"throughput fwd+explain: {BATCH / ms_explain * 1e3:.1f} img/s "
        f"({ms_explain:.2f} ms per batch of {BATCH}, one window of {WINDOW_EXPLAIN} calls; "
        f"peak memory {peak_gb:.1f} GB; the host issues one call in {host_explain:.2f} ms; "
        f"median of 10 single calls {BATCH / single_explain * 1e3:.1f} img/s, spread "
        f"{min(all_explain):.2f}-{max(all_explain):.2f} ms) [{CARD}]")
    say(f"throughput forward-only: {BATCH / ms_forward * 1e3:.1f} img/s "
        f"({ms_forward:.2f} ms per batch, one window of {WINDOW_FWD} calls; host "
        f"{host_forward:.2f} ms; median of 10 single calls "
        f"{BATCH / single_forward * 1e3:.1f} img/s, spread {min(all_forward):.2f}-"
        f"{max(all_forward):.2f} ms) [{CARD}]")
    return counts_explain, ms_explain


# --------------------------------------------------------------------------
# 6: the streaming-bandwidth probe (K4)
# --------------------------------------------------------------------------
def phase_probe():
    """K4 against its plain version, bit for bit, at the probe's shape and a
    ragged one; then the probe's own entry point, with K4's launches counted
    over that run. Returns K4's row of the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0.0
    for shape in ((PROBE_M, PROBE_C), (1001, 7)):
        xs = [torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
              for _ in range(PROBE_NIN)]
        got, want = k4.stream_add(*xs), k4.stream_add_plain(*xs)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        say(f"check stream_add {shape} bf16 bit-for-bit against the plain version: "
            f"{'ok' if same else 'FAILED'}")
        if not same:
            raise AssertionError("stream_add disagrees with its plain version")
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        del xs, got, want
    reset_launch_counts()
    r = stream_bandwidth.measure(PROBE_M, PROBE_C, 20, nin=PROBE_NIN, seed=SEED)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["stream_add"] < 1 or any(counts[k] for k in MODEL_KERNELS):
        raise AssertionError(f"probe launches {counts}: K4 alone expected")
    bound_ms = r["k4_bytes"] / PEAK_BYTES * 1e3
    say(f"probe [{PROBE_M}, {PROBE_C}] bf16, {PROBE_NIN} inputs: K4 {r['k4_ms']:.4f} ms = "
        f"{r['k4_gbs']:.1f} GB/s over its {r['k4_bytes'] / 1e6:.1f} MB "
        f"({r['k4_gbs'] / (PEAK_BYTES / 1e9):.1%} of the 3350 GB/s data-sheet rate; "
        f"bound {bound_ms:.4f} ms); torch a + b + c {r['torch_ms']:.4f} ms = "
        f"{r['torch_gbs']:.1f} GB/s over its {r['torch_bytes'] / 1e6:.1f} MB [{CARD}]")
    source, replaces = SOURCES["stream_add"]
    return {"name": "stream_add", "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts["stream_add"], "max_abs_err": worst, "ms": r["k4_ms"],
            "plain_ms": r["torch_ms"], "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}, r


# --------------------------------------------------------------------------
# 7: serving export
# --------------------------------------------------------------------------
def blend_rate(p, r_fwd, r_explain):
    """Images/s of a stream in which a fraction p is explained: the
    weighted harmonic mean of the two rates."""
    return 1.0 / ((1.0 - p) / r_fwd + p / r_explain)


def phase_serving(net, x2):
    """Exported forward and forward + explanation programs of the calibrated
    net, loaded from bytes, against the eager calls at batch 128, bf16."""
    t0 = time.perf_counter()
    blob_fwd = serving.export_forward(net, input_size=SIZE, dtype=torch.bfloat16)
    blob_explain = serving.export_explain(net, input_size=SIZE, dtype=torch.bfloat16)
    fwd, expl = serving.load_serialized(blob_fwd), serving.load_serialized(blob_explain)
    say(f"serving: exported and loaded both programs in {time.perf_counter() - t0:.1f} s "
        f"({len(blob_fwd) / 1e6:.1f} MB and {len(blob_explain) / 1e6:.1f} MB)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.rand((BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    x = torch.cat([x, 1.0 - x], dim=-1)
    x[:2] = x2
    x = x.to(torch.bfloat16)

    reset_launch_counts()
    logits, sel, w = expl.call(x)
    torch.cuda.synchronize()
    check_counts("loaded fwd+explain", launch_counts(), EXPLAIN_COUNTS)
    reset_launch_counts()
    logits_f = fwd.call(x)
    torch.cuda.synchronize()
    check_counts("loaded forward", launch_counts(), FORWARD_COUNTS)
    le, se, we = fast_dynamic_linear_weights(net, x)
    with torch.no_grad():
        lf = net(x)
    bias = net.logit_bias
    checks = {  # (value, bound): the same ops and kernels on the same inputs
        "W loaded vs eager (rel)": (rel(w.float(), we.float()), 1e-6),
        "pre-logit loaded vs eager fwd+explain (rel)": (rel(logits.double() - bias,
                                                            le.double() - bias), 1e-6),
        "pre-logit loaded vs eager forward (rel)": (rel(logits_f.double() - bias,
                                                        lf.double() - bias), 1e-6),
    }
    for key, (val, bound) in checks.items():
        say(f"serving {key}: {val:.3e} (bound {bound:.0e})")
    if not torch.equal(sel, se) or any(val > bound for val, bound in checks.values()):
        raise AssertionError("the loaded programs disagree with the eager calls")

    # every rate from one window of calls in a row, so that one call's host
    # work overlaps the card's work on the one before, as in a serving loop
    ms_fwd = window_ms(lambda: fwd.call(x), WINDOW_FWD)
    ms_explain = window_ms(lambda: expl.call(x), WINDOW_EXPLAIN)

    def mixed_period():  # one explained batch, then SERVE_EVERY - 1 forward-only
        expl.call(x)
        for _ in range(SERVE_EVERY - 1):
            fwd.call(x)

    # the window spans whole periods, so it holds exactly 1 explain in SERVE_EVERY
    ms_period = window_ms(mixed_period, WINDOW_PERIODS)
    host_fwd, host_explain = (timed_iters(lambda: fwd.call(x), 3)[2],
                              timed_iters(lambda: expl.call(x), 3)[2])
    r_fwd, r_explain = BATCH / ms_fwd * 1e3, BATCH / ms_explain * 1e3
    r_mixed = BATCH * SERVE_EVERY / ms_period * 1e3
    modeled = blend_rate(1.0 / SERVE_EVERY, r_fwd, r_explain)
    say(f"serving loaded forward-only: {r_fwd:.1f} img/s ({ms_fwd:.2f} ms per batch of "
        f"{BATCH}; one window of {WINDOW_FWD} calls; the host issues one call in "
        f"{host_fwd:.2f} ms) [{CARD}]")
    say(f"serving loaded fwd+explain: {r_explain:.1f} img/s ({ms_explain:.2f} ms; one "
        f"window of {WINDOW_EXPLAIN} calls; host {host_explain:.2f} ms) [{CARD}]")
    say(f"serving mixed loop, 1 batch in {SERVE_EVERY} explained: {r_mixed:.1f} img/s "
        f"(one window of {WINDOW_PERIODS} periods, {ms_period:.2f} ms per period); harmonic "
        f"model {modeled:.1f} img/s; measured / model - 1 = {r_mixed / modeled - 1:+.4f} "
        f"[{CARD}]")
    with torch.no_grad():
        ms_fwd_eager = window_ms(lambda: net(x), WINDOW_FWD)
    ms_explain_eager = window_ms(lambda: fast_dynamic_linear_weights(net, x), WINDOW_EXPLAIN)
    say(f"serving eager, timed the same way: forward-only {BATCH / ms_fwd_eager * 1e3:.1f} "
        f"img/s ({ms_fwd_eager:.2f} ms), fwd+explain {BATCH / ms_explain_eager * 1e3:.1f} "
        f"img/s ({ms_explain_eager:.2f} ms) [{CARD}]")

    one = explain(net, x[:1])
    rgba = one["explanation"]
    if (tuple(rgba.shape) != (SIZE, SIZE, 4) or not torch.isfinite(rgba).all()
            or float(rgba.min()) < 0 or float(rgba.max()) > 1):
        raise AssertionError("explain(): the RGBA explanation is not finite in [0, 1]")
    say(f"explain() on one image: prediction {one['prediction']}, RGBA {tuple(rgba.shape)} "
        f"in [{float(rgba.min()):.3g}, {float(rgba.max()):.3g}], finite")


# --------------------------------------------------------------------------
# 8: training
# --------------------------------------------------------------------------
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WINDOW = 64, 20, 10
TRAIN_EMA_STEPS = 10  # the recipe updates every 32 steps; 10 updates twice in 20
# one train step: K3 on every stride-1 1x1 conv (conv1 and conv3 of the 16
# bottlenecks, layer1's downsample, the classifier), no K1 or K2 (the
# batch-statistics BN folds into no affine; explain is off)
TRAIN_STEP_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                     "bcos_matmul_fwd": 34, "stream_add": 0}
# bounds of one fp32 train step of the small flagship, GPU against CPU, and
# of its bf16 amp gradient on the GPU against the fp32 gradient on the CPU.
# This net's gradients are sensitive to bf16 rounding: on the CPU the port's
# amp gradient lies 0.30 from its fp32 one (worst leaf), the JAX package's
# 0.32. Planted bf16-only faults in the backward (K3's dw halved, K3's dx
# without its row term and factor 2) read 0.52 and 0.92 on the worst leaf
# and 39x on the ratio to the CPU amp gradient's own distance.
TRAIN_PARITY_BOUNDS = {"loss": 1e-5, "gradient": 1e-4, "running_var": 1e-5,
                       "bf16 gradient": 0.45, "bf16 gradient / cpu bf16 spread": 2.0}


def k3_shapes(model, batch, size):
    """[(module name, M, K, N)] of every conv that ``ops.bcos.bcos_conv2d``
    sends to K3 (a bias-free b=2 1x1 at stride 1) in one forward of the
    backbone ``model`` at this batch and input size, in forward order: read
    from the convs' inputs in one forward at batch 1 (forward hooks), so it
    holds for any family. Its K3 launches are not counted by any caller."""
    names = {mod: name for name, mod in model.named_modules()}
    seen = []

    def hook(mod, args, out):
        if (mod.kernel_size == (1, 1) and mod.stride == (1, 1) and mod.padding == (0, 0)
                and mod.groups == 1 and mod.max_out == 1 and mod.bias is None and mod.b == 2):
            _, h, w, k = args[0].shape
            seen.append((names[mod], batch * h * w, k, mod.weight.shape[0]))

    convs = [mod for mod in model.modules() if isinstance(mod, BcosConv2d)]
    handles = [mod.register_forward_hook(hook) for mod in convs]
    try:
        with torch.no_grad():
            model(torch.zeros((1, size, size, convs[0].in_channels),
                              device=convs[0].weight.device))
    finally:
        for handle in handles:
            handle.remove()
    return seen


def train_k3_launches(model, batch, size):
    """[("bcos_matmul_fwd", M, K, N, False)] of every K3 launch of one train
    step: each stride-1 1x1 conv and the classifier (``k3_shapes``)."""
    return [("bcos_matmul_fwd", m, k, n, False) for _, m, k, n in k3_shapes(model, batch, size)]


def time_train_k3(model, stream_rate):
    """K3's time over one train step's launches (bf16, batch 64;
    ``time_shapes``)."""
    per_shape = collections.Counter(train_k3_launches(model, TRAIN_BATCH, SIZE))
    if sum(per_shape.values()) != TRAIN_STEP_COUNTS["bcos_matmul_fwd"]:
        raise AssertionError(f"the train shapes list {sum(per_shape.values())} K3 launches")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    row = time_shapes(per_shape, stream_rate, gen, tag="train ")["bcos_matmul_fwd"]
    say(f"bcos_matmul_fwd per train step ({sum(per_shape.values())} launches): "
        f"{row['ms']:.4f} ms; bound {1e3 * row['bound_s']:.4f} ms at the data-sheet rate, "
        f"{1e3 * row['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} GB/s; "
        f"plain {row['plain_ms']:.4f} ms, torch.matmul {row['library_ms']:.4f} ms [{CARD}]")
    return row


def device_profile(fn, calls, top=8):
    """(card ms per call, [(kernel, ms per call)] of the ``top`` largest):
    the sum of the card's kernel time over ``calls`` calls of ``fn``, from a
    torch.profiler trace; (None, []) if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()]
    total = sum(ms for _, ms in rows)
    return (total or None), sorted(rows, key=lambda r: -r[1])[:top]


class RepeatedBatch:
    """In-script data module: one batch on the card, ``steps`` times per
    epoch; validation sees it once."""

    def __init__(self, batch, steps):
        self.batch, self.steps = batch, steps
        self.batch_size = batch["image"].shape[0]

    def setup(self, stage=None):
        pass

    def train_dataloader(self, seed=0):
        return _RepeatedLoader(self.batch, self.steps)

    def val_dataloader(self):
        return [self.batch]


class _RepeatedLoader:
    def __init__(self, batch, steps):
        self.batch, self.steps = batch, steps

    def __iter__(self):
        return iter([self.batch] * self.steps)

    def __len__(self):
        return self.steps

    def set_epoch(self, epoch):
        pass


class RecordedLoss:
    """The train criterion, keeping each step's loss (on the card)."""

    def __init__(self, criterion):
        self.criterion, self.losses = criterion, []

    def __call__(self, out, target):
        loss = self.criterion(out, target)
        self.losses.append(loss.detach())
        return loss


def train_experiment(save_dir, criterion):
    """The resnet_50 recipe (ImageNet/bcosification experiment_parameters)
    plus the EMA of scripts/bench_train.py, one epoch long."""
    return types.SimpleNamespace(save_dir=Path(save_dir), config=dict(
        criterion=criterion, test_criterion=BinaryCrossEntropyLoss(),
        optimizer=OptimizerFactory("Adam", 1e-4, bcosify=True, b_opt=False),
        lr_scheduler=LRSchedulerFactory("cosineannealinglr", epochs=90),
        trainer=dict(max_epochs=1), use_agc=True,
        ema={"decay": 0.9998, "steps": TRAIN_EMA_STEPS}, model={}))


def _raw_grads(model, criterion, batch, amp):
    """{name: gradient in f64 on the CPU} of one train-mode backward of a
    copy of ``model`` (the image in bf16 under amp)."""
    m = copy.deepcopy(model)
    image = batch["image"].to(torch.bfloat16) if amp else batch["image"]
    criterion(m(image, train=True).float(), batch["label"]).backward()
    return {n: p.grad.double().cpu() for n, p in m.named_parameters()}


def train_step_parity(net, batch):
    """One fp32 train step of ``net`` (AGC, Adam with the cosine, EMA) on the
    GPU against the same step of a CPU copy on the same batch, and the bf16
    amp gradient on the GPU against the fp32 one on the CPU: {check: (value,
    bound)} for the loss, the worst gradient leaf (||d||/||ref||, the raw
    gradients of one backward), the BN running_var after the step, the worst
    bf16 leaf, and the worst leaf's ratio of that distance to the CPU bf16
    gradient's own (the spread bf16 rounding alone makes).

    A leaf whose fp32 CPU gradient is zero up to rounding (below 1e-6 of the
    largest leaf's norm: the DenseNet's norm0 gamma, whose per-channel scale
    every train-mode BN after it divides out again) is measured against the
    largest leaf's norm instead of its own, and has no bf16 ratio (a ratio
    of two rounding noises)."""
    recipe = train_experiment(".", UniformOffLabelsBCEWithLogitsLoss()).config
    schedule = recipe["lr_scheduler"].create(1e-4, steps_per_epoch=10)
    results = []
    for dev in ("cuda", "cpu"):
        state = steps_lib.create_train_state(net, recipe["optimizer"].create, with_ema=True,
                                             device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        grads = _raw_grads(state.model, recipe["criterion"], b, amp=False)
        grads_bf16 = _raw_grads(state.model, recipe["criterion"], b, amp=True)
        step = steps_lib.make_train_step(recipe["criterion"], schedule, use_agc=True,
                                         ema_decay=0.9, ema_steps=1)
        state, metrics = step(state, b)
        rv = torch.cat([buf.double().cpu() for n, buf in state.model.named_buffers()
                        if n.endswith("running_var")])
        results.append((float(metrics["loss"]), grads, grads_bf16, rv))
    (loss_g, grads_g, bf16_g, rv_g), (loss_c, grads_c, bf16_c, rv_c) = results
    top = max(float(g.norm()) for g in grads_c.values())
    noise = {n for n, g in grads_c.items() if float(g.norm()) < 1e-6 * top}

    def leaf(got, n):
        return float((got[n] - grads_c[n]).norm()) / (top if n in noise else
                                                      float(grads_c[n].norm()))

    signal = [n for n in grads_c if n not in noise]
    return {"loss": (abs(loss_g - loss_c) / abs(loss_c), TRAIN_PARITY_BOUNDS["loss"]),
            "gradient": (max(leaf(grads_g, n) for n in grads_c),
                         TRAIN_PARITY_BOUNDS["gradient"]),
            "running_var": (rel(rv_g, rv_c), TRAIN_PARITY_BOUNDS["running_var"]),
            "bf16 gradient": (max(leaf(bf16_g, n) for n in grads_c),
                              TRAIN_PARITY_BOUNDS["bf16 gradient"]),
            "bf16 gradient / cpu bf16 spread": (
                max(leaf(bf16_g, n) / leaf(bf16_c, n) for n in signal),
                TRAIN_PARITY_BOUNDS["bf16 gradient / cpu bf16 spread"])}


def phase_train(net, stream_rate):
    """Trainer.fit, resume, the timed window and the fp32 GPU-vs-CPU step.
    Returns K3's train-step numbers for the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    image = torch.rand((TRAIN_BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    batch = {"image": torch.cat([image, 1.0 - image], dim=-1),
             "label": torch.randint(0, net.num_classes, (TRAIN_BATCH,), device="cuda",
                                    generator=gen)}
    data = RepeatedBatch(batch, TRAIN_STEPS)
    criterion = RecordedLoss(UniformOffLabelsBCEWithLogitsLoss())
    with tempfile.TemporaryDirectory() as tmp:
        exp = train_experiment(tmp, criterion)
        t0 = time.perf_counter()
        reset_launch_counts()
        trainer = Trainer(exp, {"amp": True})
        state = trainer.fit(net, data)
        torch.cuda.synchronize()
        counts = launch_counts()
        fit_s = time.perf_counter() - t0
        evals = 3  # the initial, the epoch's and the EMA validation: one forward each
        want = {"bcos_conv1x1_fwd": 36 * evals, "bcos_conv1x1_bwd_explain": 0,
                "bcos_matmul_fwd": 34 * TRAIN_STEPS + evals, "stream_add": 0}
        say(f"train: Trainer.fit of {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, bf16 amp, took "
            f"{fit_s:.1f} s; launches {counts}")
        check_counts("Trainer.fit", counts, want)
        losses = [float(v) for v in criterion.losses]
        say("train loss per 5 steps: " + ", ".join(
            f"step {i}: {losses[i]:.6f}" for i in range(0, len(losses), 5))
            + f", step {len(losses) - 1}: {losses[-1]:.6f}")
        history = trainer.metrics.history
        say(f"train metrics: {json.dumps({k: v for k, v in history.items()})}")
        if (len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses)
                or not sum(losses[-5:]) < sum(losses[:5])):
            raise AssertionError(f"train losses are not finite and falling: {losses}")
        if state.step != TRAIN_STEPS or trainer.ckpt.available_checkpoints() != [0]:
            raise AssertionError("fit did not take its steps or save its checkpoint")

        resumed = Trainer(exp, {"amp": True}).fit(net, data, max_epochs=2, fast_dev_run=True)
        if resumed.step != TRAIN_STEPS + 1 or trainer.ckpt.available_checkpoints() != [0, 1]:
            raise AssertionError(f"resume: step {resumed.step}, checkpoints "
                                 f"{trainer.ckpt.available_checkpoints()}")
        say(f"train: resumed from epoch 0 for one step (step {resumed.step}); checkpoints "
            f"{trainer.ckpt.available_checkpoints()}")

    step = steps_lib.make_train_step(criterion, 1e-4, use_agc=True, ema_decay=0.99,
                                     ema_steps=32, amp=True)
    step(state, batch)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    step(state, batch)
    torch.cuda.synchronize()
    per_step = launch_counts()
    say(f"train: launches per train step {per_step}")
    check_counts("train step", per_step, TRAIN_STEP_COUNTS)
    torch.cuda.reset_peak_memory_stats()
    host = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_WINDOW):
        t0 = time.perf_counter()
        step(state, batch)
        host.append(1e3 * (time.perf_counter() - t0))
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TRAIN_WINDOW
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"train step: {TRAIN_BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per step of "
        f"{TRAIN_BATCH}, one window of {TRAIN_WINDOW} steps; the host issues a step in "
        f"{statistics.median(host):.2f} ms (median; {min(host):.2f}-{max(host):.2f}); peak "
        f"memory {peak_gb:.1f} GB) [{CARD}]")
    step_img_s = TRAIN_BATCH / ms * 1e3
    busy, top = device_profile(lambda: step(state, batch), 3)
    if busy is None:
        say("train step: the profiler trace holds no device time; card time not measured")
    else:
        say(f"train step: the card is busy {busy:.2f} of {ms:.2f} ms per step (idle share "
            f"{1 - busy / ms:.1%}; torch.profiler over 3 steps) [{CARD}]")
        for name, kms in top:
            say(f"train step card time: {kms:8.3f} ms per step  {name[:110]}")
    if not all(math.isfinite(float(p.detach().float().sum())) for p in state.model.parameters()):
        raise AssertionError("parameters are not finite after training")
    del state, resumed

    row = time_train_k3(net.model, stream_rate)
    row["launches"] = per_step["bcos_matmul_fwd"]
    row["step_img_s"] = step_img_s

    small = build_bcosified_resnet({**FLAGSHIP, "name": "resnet50"}, num_classes=10,
                                   inplanes=8, layers=("bottleneck", (1, 1)), seed=SEED)
    image = torch.rand((4, 32, 32, 3), device="cuda", generator=gen)
    image = torch.cat([image, 1.0 - image], dim=-1)
    calibrate(small, image[:1])
    checks = train_step_parity(small, {"image": image, "label": torch.tensor(
        [1, 3, 5, 7], device="cuda")})
    for key, (val, bound) in checks.items():
        say(f"train parity small flagship gpu vs cpu fp32, {key}: {val:.3e} (bound {bound:g})")
    if any(not val <= bound for val, bound in checks.values()):
        raise AssertionError("the train step on the GPU disagrees with the CPU")
    return row


# --------------------------------------------------------------------------
# 9: the entry points, fed from JPEGs
# --------------------------------------------------------------------------
ENTRY_CLASSES, ENTRY_TRAIN, ENTRY_VAL = 10, 704, 128  # 11 train batches of 64, 2 val
ENTRY_EXPERIMENT = ("ImageNet", "bcosification", "resnet_50")
EVAL_BATCH = 64  # the resnet_50 experiment's batch, also of evaluate and validation
# per eval batch of the ResNet-50: K1 on every 1x1 conv of the trunk, K3 on
# the classifier
EVAL_BATCH_COUNTS = {"bcos_conv1x1_fwd": 36, "bcos_conv1x1_bwd_explain": 0,
                     "bcos_matmul_fwd": 1, "stream_add": 0}
# the eval-mode gradient without explain (fault C1's route): no K1; K3 on
# the 34 stride-1 1x1 convs; the 36 eligible convs run unfused
EVAL_GRADIENT_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                        "bcos_matmul_fwd": 34, "stream_add": 0}


K1_DTYPES = collections.defaultdict(collections.Counter)  # path -> {dtype: K1 calls}


@contextlib.contextmanager
def k1_dtypes(path):
    """While active, counts the dtype of each activation that reaches K1
    (``_Conv1x1BnAct``, the autograd function of every fused 1x1) under
    ``path`` in K1_DTYPES; the launch counters are untouched."""
    forward = k12._Conv1x1BnAct.forward

    def recording(ctx, x2, *args):
        K1_DTYPES[path][str(x2.dtype)[6:]] += 1
        return forward(ctx, x2, *args)

    k12._Conv1x1BnAct.forward = staticmethod(recording)
    try:
        yield
    finally:
        k12._Conv1x1BnAct.forward = staticmethod(forward)


def scaled_counts(counts, k, plus=None):
    out = {name: k * v for name, v in counts.items()}
    for name, v in (plus or {}).items():
        out[name] += v
    return out


def eval_gradients(net, x, weights=False):
    """{"x": the input gradient[, parameter name: its gradient]} (f64 on
    the CPU) of sum(logits * c), c a cotangent made from SEED, for
    net(x, train=False) without explain: the gradient the IxG and Grad
    explainers take. The net is copied, so its own weights stay frozen."""
    m = copy.deepcopy(net).requires_grad_(weights)
    xx = x.detach().clone().requires_grad_(True)
    out = m(xx, train=False)
    c = torch.randn(out.shape, generator=torch.Generator().manual_seed(SEED)).to(out.device)
    out.backward(c.to(out.dtype))
    grads = {"x": xx.grad.double().cpu()}
    if weights:
        grads.update({n: p.grad.double().cpu() for n, p in m.named_parameters()})
    return grads


class TimedLoader:
    """A train loader that records when its epoch's iteration starts and
    when it ends, after the card has finished the last step's work."""

    def __init__(self, loader):
        self.loader, self.spans = loader, []

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        t0 = time.perf_counter()
        n = 0
        for batch in self.loader:
            n += len(batch["label"])
            yield batch
        torch.cuda.synchronize()
        self.spans.append((n, time.perf_counter() - t0))


class TimedData:
    """The data module, with its train loader timed (``TimedLoader``)."""

    def __init__(self, datamodule):
        self.datamodule, self.loader = datamodule, None
        self.batch_size = datamodule.batch_size

    def setup(self, stage=None):
        self.datamodule.setup(stage)

    def train_dataloader(self, seed=0):
        self.loader = TimedLoader(self.datamodule.train_dataloader(seed=seed))
        return self.loader

    def val_dataloader(self):
        return self.datamodule.val_dataloader()


def copy_ms(batch, calls=5):
    """ms of one host-to-card copy of the batch's image array (pageable
    memory), over ``calls`` copies in a row."""
    image = torch.from_numpy(batch["image"])
    image.to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        image.to("cuda")
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls, image.numel() * image.element_size()


@contextlib.contextmanager
def experiment_root():
    """The experiment root in a temporary directory while the context lasts."""
    old = settings.EXPERIMENT_ROOT
    with tempfile.TemporaryDirectory() as tmp:
        settings.EXPERIMENT_ROOT = tmp
        try:
            yield Path(tmp)
        finally:
            settings.EXPERIMENT_ROOT = old


@contextlib.contextmanager
def synthetic_imagenet():
    """A synthetic ImageNet-layout JPEG tree in a temporary directory (see
    the module docstring, phase 9), with IMAGENET_PATH pointing into it and
    the experiment root in another (``experiment_root``) while the context
    lasts; yields the experiment root."""
    old_paths = (settings.IMAGENET_PATH, os.environ.get("IMAGENET_PATH"))
    with tempfile.TemporaryDirectory() as tmp, experiment_root() as exp_root:
        data_root = Path(tmp) / "imagenet"
        t0 = time.perf_counter()
        write_imagenet_tree(data_root, ENTRY_CLASSES, ENTRY_TRAIN, ENTRY_VAL, seed=SEED)
        say(f"entry: wrote {ENTRY_TRAIN} train and {ENTRY_VAL} val JPEGs (500x375, quality 90, "
            f"{ENTRY_CLASSES} classes) in {time.perf_counter() - t0:.1f} s")
        os.environ["IMAGENET_PATH"] = settings.IMAGENET_PATH = str(data_root)
        try:
            yield exp_root
        finally:
            settings.IMAGENET_PATH, env = old_paths
            if env is None:
                os.environ.pop("IMAGENET_PATH", None)
            else:
                os.environ["IMAGENET_PATH"] = env


def phase_entry(net, x2, step_img_s, exp_root):
    """The train and evaluate entry points on the synthetic JPEG tree, then
    fault C1's route. Returns its numbers for the record."""
    out = _entry_runs(net, x2, step_img_s, exp_root)
    out.update(_c1_route(net, x2))
    return out


def _entry_runs(net, x2, step_img_s, exp_root):
    exp = Experiment(*ENTRY_EXPERIMENT)
    datamodule = exp.get_datamodule()
    datamodule.setup("fit")
    loader = datamodule.train_dataloader(seed=0)
    t0 = time.perf_counter()
    n, last = 0, None
    for last in loader:
        n += len(last["label"])
    loader_s = time.perf_counter() - t0
    if n != ENTRY_TRAIN or last["image"].shape != (64, SIZE, SIZE, 6):
        raise AssertionError(f"the train loader gave {n} images, last batch "
                             f"{last['image'].shape}")
    loader_img_s = n / loader_s
    say(f"entry loader alone: {loader_img_s:.1f} img/s ({n} images in {len(loader)} batches "
        f"of 64 in {loader_s:.2f} s; PIL decode in {datamodule.num_workers} threads on a host "
        f"with {os.cpu_count()} CPUs) [{CARD}]")
    ms_copy, nbytes = copy_ms(last)
    say(f"entry host-to-card copy of one batch ({nbytes / 1e6:.1f} MB float32, pageable): "
        f"{ms_copy:.2f} ms = {nbytes / ms_copy / 1e6:.1f} GB/s [{CARD}]")

    model = exp.get_model()
    calibrate(model, x2[:1])
    data = TimedData(datamodule)
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(exp, {"amp": True})
    with k1_dtypes("Trainer.fit validation (amp)"):
        state = trainer.fit(model, data, max_epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()
    steps, val_batches = ENTRY_TRAIN // 64, -(-ENTRY_VAL // 64)
    evals = 2 * val_batches  # the initial and the epoch's validation
    check_counts("Trainer.fit from JPEGs", counts, scaled_counts(
        EVAL_BATCH_COUNTS, evals, {"bcos_matmul_fwd": TRAIN_STEP_COUNTS["bcos_matmul_fwd"]
                                   * steps}))
    (n_fit, train_s), = data.loader.spans
    fit_img_s = n_fit / train_s
    history = trainer.metrics.history
    say(f"entry Trainer.fit from JPEGs (bf16 amp, batch 64, {steps} steps): {fit_img_s:.1f} "
        f"img/s over the epoch's train loop ({train_s:.2f} s); phase 8's repeated batch on the "
        f"card: {step_img_s:.1f} img/s; fit with two validations and a checkpoint "
        f"{fit_s:.1f} s; K3 launches per train step "
        f"{(counts['bcos_matmul_fwd'] - evals) / steps:g}; launches {counts} [{CARD}]")
    say(f"entry fit metrics: {json.dumps(history)}")
    if state.step != steps or not math.isfinite(history["train_loss"][-1][1]):
        raise AssertionError(f"fit from JPEGs: step {state.step}, history {history}")
    del state, trainer, model

    cli_round_trip(ENTRY_EXPERIMENT, exp_root, EVAL_BATCH_COUNTS,
                   TRAIN_STEP_COUNTS["bcos_matmul_fwd"], ("last", "fresh"))
    return {"loader_img_s": loader_img_s, "fit_img_s": fit_img_s, "copy_ms": ms_copy}


def cli_round_trip(experiment, exp_root, eval_counts, train_step_k3, reloads, tag="entry"):
    """``train --fast_dev_run`` of ``experiment`` (resuming from the
    checkpoint of epoch 0 under ``exp_root``), then ``evaluate --reload``
    each of ``reloads``, with the launch counts of each (``eval_counts`` per
    eval batch, ``train_step_k3`` K3 launches per train step); the top-1 and
    top-5 of ``--reload last`` must equal the val_acc1/val_acc5 the train
    command logged."""
    exp = Experiment(*experiment)
    val_batches = -(-ENTRY_VAL // 64)
    base = ["--base_directory", str(exp_root)]
    reset_launch_counts()
    train_cli.main(["--dataset", experiment[0], "--base_network", experiment[1],
                    "--experiment_name", experiment[2], "--amp", "--fast_dev_run", *base])
    torch.cuda.synchronize()
    counts = launch_counts()
    check_counts(f"{experiment[2]} train --fast_dev_run", counts, scaled_counts(
        eval_counts, val_batches, {"bcos_matmul_fwd": train_step_k3}))
    if exp.available_checkpoints() != [0, 1]:
        raise AssertionError(f"train --fast_dev_run: checkpoints {exp.available_checkpoints()}")
    logged = exp.load_metrics()
    want = (logged["val_acc1"][-1], logged["val_acc5"][-1])
    say(f"{tag} train --experiment_name {experiment[2]} --fast_dev_run: resumed from epoch 0, "
        f"one step, checkpoints {exp.available_checkpoints()}, logged val_acc1/val_acc5 at "
        f"epoch {want[0][0]}: {want[0][1]:.6f} / {want[1][1]:.6f}; launches {counts}")

    results = {}
    for reload in reloads:
        reset_launch_counts()
        t0 = time.perf_counter()
        with k1_dtypes(f"{experiment[2]} evaluate"):
            top1, top5, (c1, c5, n) = evaluate_cli.main(
                ["--experiment_name", experiment[2], "--reload", reload, *base])
        torch.cuda.synchronize()
        counts = launch_counts()
        say(f"{tag} evaluate --reload {reload}: top-1 {top1:.6f} ({c1}/{n}), top-5 {top5:.6f} "
            f"({c5}/{n}) in {time.perf_counter() - t0:.1f} s; launches {counts}")
        check_counts(f"evaluate --reload {reload}", counts,
                     scaled_counts(eval_counts, val_batches))
        if n != ENTRY_VAL:
            raise AssertionError(f"evaluate --reload {reload} saw {n} images")
        results[reload] = (top1, top5)
    if results["last"] != (want[0][1], want[1][1]):
        raise AssertionError(f"evaluate --reload last {results['last']} differs from the "
                             f"logged {want}")
    say(f"{tag} evaluate --reload last equals the train command's logged "
        f"val_acc1/val_acc5: True")


def _c1_route(net, x2):
    """Fault C1's route at full width: the eval-mode input gradient without
    explain, GPU against CPU in fp32, bounded by ten times the CPU's own
    spread under 1e-7 relative input noise; then phase 5's counts."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    route = resnet._conv_bn_act.grad_route
    reset_launch_counts()
    got = eval_gradients(net, x2)["x"]
    torch.cuda.synchronize()
    counts = launch_counts()
    unfused = resnet._conv_bn_act.grad_route - route
    check_counts("eval-mode gradient", counts, EVAL_GRADIENT_COUNTS)
    if unfused != 36:
        raise AssertionError(f"eval-mode gradient: {unfused} convs took the unfused route")
    cpu_net = copy.deepcopy(net).to("cpu")
    want = eval_gradients(cpu_net, x2.cpu())["x"]
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 7))
    spread = rel(eval_gradients(cpu_net, x2.cpu() * (1 + 1e-7 * noise))["x"], want)
    err, bound = rel(got, want), 10 * spread
    say(f"entry C1 route: eval-mode input gradient without explain, fp32, 2 images, gpu vs cpu "
        f"{err:.3e} (bound {bound:.3e} = 10 x the cpu spread under 1e-7 relative input noise, "
        f"{spread:.3e}); {unfused} convs unfused; launches {counts}")
    if not err <= bound or not torch.isfinite(got).all():
        raise AssertionError("the eval-mode gradient on the GPU disagrees with the CPU")
    reset_launch_counts()
    fast_dynamic_linear_weights(net, x2)
    torch.cuda.synchronize()
    check_counts("fwd+explain after the gradient", launch_counts(), EXPLAIN_COUNTS)
    reset_launch_counts()
    with torch.no_grad():
        net(x2)
    torch.cuda.synchronize()
    check_counts("forward after the gradient", launch_counts(), FORWARD_COUNTS)
    say("entry phase 5's launch counts after the gradient: unchanged (36 / 37 / 1 and 36 / 0 / 1)")
    return {"c1_err": err, "c1_bound": bound}


# --------------------------------------------------------------------------
# 10: DenseNet-121
# --------------------------------------------------------------------------
DENSENET_EXPERIMENT = ("ImageNet", "bcosification", "densenet_121")
# (label, M, Cin, Cout, relu) at batch 128, 224x224: the first and the
# widest conv1 of block 1, transition 1, the deepest conv1 of block 3,
# transition 3 and the classifier. relu: K2 with the conv1's folded norm2 +
# act2 (mult and mask); otherwise K2 as K3's explanation backward (neither)
DENSENET_CHECK_SHAPES = [
    ("densenet b1.l1.conv1", 401408, 64, 128, True),
    ("densenet b1.l6.conv1", 401408, 224, 128, True),
    ("densenet transition1", 401408, 256, 128, False),
    ("densenet b3.l24.conv1", 25088, 992, 128, True),
    ("densenet transition3", 25088, 1024, 512, False),
    ("densenet classifier", 6272, 1024, 1000, False),
]
# one forward: K3 at the 62 1x1 convs (58 conv1s, 3 transitions, the
# classifier); the explanation adds K2 at each; no K1 (no norm is folded
# into a conv); a train step: K3 at the same 62
DENSENET_FORWARD_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                           "bcos_matmul_fwd": 62, "stream_add": 0}
DENSENET_EXPLAIN_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 62,
                           "bcos_matmul_fwd": 62, "stream_add": 0}
WINDOW_S = 1.7  # seconds of the card's work per timing window


def densenet_launches(model, batch, size):
    """[(kernel, M, K, N, relu)] of every kernel launch of one fast
    forward + explanation of the DenseNet (``explain/fast_densenet.py``):
    K3 at each 1x1 conv, K2 at each, with the mask where it folds a
    conv1's act2."""
    relu = isinstance(model.act0, ReLU)
    launches = []
    for name, m, k, n in k3_shapes(model, batch, size):
        launches += [("bcos_matmul_fwd", m, k, n, False),
                     ("bcos_conv1x1_bwd_explain", m, k, n, relu and name.endswith("conv1"))]
    return launches


def check_densenet_kernels(worst):
    """K3 and K2 against their plain versions at DENSENET_CHECK_SHAPES, in
    both dtypes with phase 3's bounds (K2 as the DenseNet pass calls it)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for label, m, k, n, relu in DENSENET_CHECK_SHAPES:
            x, wt, mult, add, ct = operands(m, k, n, dtype, gen)
            a = k12.conv1x1_fwd_plain(x, wt, mult, add, relu=True) if relu else None
            mu = mult if relu else None
            results = [
                ("bcos_matmul_fwd", "", k3.bcos_matmul_fwd(x, wt, eps=1e-6, eps_outside=False),
                 k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=1e-6, eps_outside=False)),
                ("bcos_conv1x1_bwd_explain", "", k12.conv1x1_bwd_explain(x, wt, ct, a, mu,
                                                                           relu=relu),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct),
                                               None if a is None else ref(a), mu, relu=relu)),
            ]
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, label, dtype, got, want)
            del x, wt, ct, a, results


def densenet_parity(net, x2):
    """fp32, 2 images: the fast pass on the GPU against the CPU, the pre-logit
    features within 1e-4 and the argmax identical; W with PyTorch's own CUDA
    convs in place of cuDNN's within ten times the CPU's own spread under
    1e-7 relative input noise, and W with cuDNN within phase 4's bound;
    then the generic autograd W on the GPU against the fast one (1e-4).

    Each cuDNN conv alone agrees with the CPU to 6e-7, yet through the 120
    layers' ReLU masks cuDNN's fp32 convs move W by ~240 times that spread,
    PyTorch's own by about one spread (PERF.md §6): the kernels and the
    pass are held with the latter."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lg, sg, wg = fast_densenet.fast_dynamic_linear_weights(net, x2)
    lm, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x2)
    torch.backends.cudnn.enabled = False
    try:
        _, _, w_native = fast_densenet.fast_dynamic_linear_weights(net, x2)
    finally:
        torch.backends.cudnn.enabled = True
    cpu_net = copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    lc, sc, wc = fast_densenet.fast_dynamic_linear_weights(cpu_net, x2.cpu(), device="cpu")
    cpu_s = time.perf_counter() - t0
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 9))
    _, _, wn = fast_densenet.fast_dynamic_linear_weights(
        cpu_net, x2.cpu() * (1 + 1e-7 * noise), device="cpu")
    spread = rel(wn, wc)
    bias = net.logit_bias
    err, err_native = rel(wg, wc), rel(w_native, wc)
    checks = {
        "W gpu-kernels (torch convs) vs cpu-plain": (err_native, 10 * spread),
        "W gpu-kernels (cudnn convs) vs cpu-plain": (err, 1e-3),
        "W module-path vs fast-path (gpu)": (rel(wm, wg), 1e-4),
        "pre-logit gpu vs cpu (max rel)": (float(
            ((lg.double().cpu() - bias) - (lc.double() - bias)).abs().max()
            / (lc.double() - bias).abs().max()), 1e-4),
        "pre-logit module vs fast (max rel)": (float(
            (lm.double() - lg.double()).abs().max() / (lg.double() - bias).abs().max()), 1e-4),
    }
    say(f"densenet parity W on the cpu under 1e-7 relative input noise: {spread:.3e}; "
        f"gpu vs cpu {err_native:.3e} = {err_native / spread:.2f} x that spread with PyTorch's "
        f"CUDA convs, {err:.3e} = {err / spread:.2f} x with cuDNN's")
    for key, (val, bound) in checks.items():
        say(f"densenet parity {key}: {val:.3e} (bound {bound:.3e})")
    same_sel = bool((sg.cpu() == sc).all() and (sm == sg).all())
    say(f"densenet parity argmax identical: {same_sel}; cpu plain pass took {cpu_s:.1f} s")
    if not same_sel or any(not val <= bound for val, bound in checks.values()):
        raise AssertionError("DenseNet-121 parity failed")
    if not all(torch.isfinite(t).all() for t in (lg, wg)) or wg.shape != x2.shape:
        raise AssertionError("DenseNet-121 outputs are not finite or mis-shaped")


def _batch128(x2, seed):
    """bf16 batch of 128 whose first two images are x2 (rounded to bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    x = torch.cat([x, 1.0 - x], dim=-1)
    x[:2] = x2
    return x.to(torch.bfloat16)


def kernel_counts(launches):
    """{kernel: launches} over a launch list, every kernel of the line."""
    counts = collections.Counter(key[0] for key in launches)
    return {name: counts.get(name, 0) for name in MODEL_KERNELS + ("stream_add",)}


def counted(fn):
    """(fn(), the launch counts of that call alone)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def windowed(fn):
    """(ms per call over one window of about WINDOW_S of the card's work,
    the calls in it, the median host ms to issue one call, the peak memory
    in GB of one call)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    single, _, host = timed_iters(fn, 3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    calls = max(3, round(1e3 * WINDOW_S / single))
    return window_ms(fn, calls), calls, host, peak_gb


def densenet_throughput(net, x2):
    """Forward-only and forward + explanation images/s at batch 128, bf16,
    with each call's launch counts, host issue time and peak memory."""
    x = _batch128(x2, SEED + 10)

    def explain_call():
        return fast_densenet.fast_dynamic_linear_weights(net, x)

    def forward_call():
        with torch.no_grad():
            return net(x)

    explain_call()
    (logits, sel, w), counts_explain = counted(explain_call)
    _, counts_forward = counted(forward_call)
    say(f"densenet launches per fwd+explain call: {counts_explain}; per forward: "
        f"{counts_forward}")
    check_counts("densenet fwd+explain", counts_explain, DENSENET_EXPLAIN_COUNTS)
    check_counts("densenet forward", counts_forward, DENSENET_FORWARD_COUNTS)
    if not (torch.isfinite(logits).all() and torch.isfinite(w).all()) or w.shape != x.shape:
        raise AssertionError("DenseNet-121 bf16 outputs are not finite or mis-shaped")
    l_ref, _, w_ref = fast_densenet.fast_dynamic_linear_weights(net, x[:2].float())
    pre = (logits[:2].double() - net.logit_bias, l_ref.double() - net.logit_bias)
    say(f"densenet bf16 vs fp32 on the first two images: W rel {rel(w[:2].float(), w_ref):.3e}, "
        f"pre-logit max rel {float((pre[0] - pre[1]).abs().max() / pre[1].abs().max()):.3e}")
    del logits, sel, w, l_ref, w_ref
    out = {}
    for what, fn in (("fwd+explain", explain_call), ("forward-only", forward_call)):
        ms, calls, host, peak_gb = windowed(fn)
        say(f"densenet throughput {what}: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per batch "
            f"of {BATCH}, one window of {calls} calls; the host issues one call in {host:.2f} "
            f"ms; peak memory of one call {peak_gb:.2f} GB) [{CARD}]")
        out[what] = {"img_s": BATCH / ms * 1e3, "ms": ms, "host_ms": host, "peak_gb": peak_gb}
    return out


# the exported DenseNet-121's dense layers per block: the fewest that keep
# every 1x1's input channels a multiple of 8 (bf16 TMA rows: 64, 96, 128,
# 64, 96, 48, 80, 40, 72; with one layer per block a transition's 36
# channels would be padded)
SERVE_DENSENET_BLOCKS = (2, 1, 1, 1)


def densenet_serving(x2):
    """The forward and the forward + explanation programs of the DenseNet-121
    cut to SERVE_DENSENET_BLOCKS (full width, random init from SEED,
    gamma-calibrated: the export's time is its traced ops) exported, saved
    to bytes and loaded back; at batch 128, bf16, against the eager calls
    (argmax identical, logits and W within 1e-6 relative: the same ops and
    kernels on the same inputs; the same launch counts), then timed."""
    model_config = Experiment(*DENSENET_EXPERIMENT).model_config
    net = build_bcosified_densenet(model_config, seed=SEED, arch_cfg={
        **DENSENET_CONFIGS[model_config["name"]], "block_config": SERVE_DENSENET_BLOCKS})
    calibrate(net, x2[:1])
    launches = densenet_launches(net.model, 1, SIZE)
    explain_counts = kernel_counts(launches)
    forward_counts = kernel_counts([key for key in launches if key[0] == "bcos_matmul_fwd"])
    t0 = time.perf_counter()
    blob_fwd = serving.export_forward(net, input_size=SIZE, dtype=torch.bfloat16)
    blob = serving.export_explain(net, input_size=SIZE, dtype=torch.bfloat16)
    fwd, program = serving.load_serialized(blob_fwd), serving.load_serialized(blob)
    export_s = time.perf_counter() - t0
    say(f"densenet serving (blocks {SERVE_DENSENET_BLOCKS}): exported and loaded both programs "
        f"in {export_s:.1f} s "
        f"({len(blob_fwd) / 1e6:.1f} MB and {len(blob) / 1e6:.1f} MB)")
    x = _batch128(x2, SEED + 11)
    (logits, sel, w), counts = counted(lambda: program.call(x))
    check_counts("densenet loaded fwd+explain", counts, explain_counts)
    logits_f, counts_f = counted(lambda: fwd.call(x))
    check_counts("densenet loaded forward", counts_f, forward_counts)
    le, se, we = fast_densenet.fast_dynamic_linear_weights(net, x)
    with torch.no_grad():
        lf = net(x)
    bias = net.logit_bias
    checks = {
        "W loaded vs eager (rel)": (rel(w.float(), we.float()), 1e-6),
        "pre-logit loaded vs eager fwd+explain (rel)": (rel(logits.double() - bias,
                                                            le.double() - bias), 1e-6),
        "pre-logit loaded vs eager forward (rel)": (rel(logits_f.double() - bias,
                                                        lf.double() - bias), 1e-6),
    }
    for key, (val, bound) in checks.items():
        say(f"densenet serving {key}: {val:.3e} (bound {bound:.0e})")
    if (not torch.equal(sel, se) or not torch.equal(logits_f.argmax(1), lf.argmax(1))
            or any(not val <= bound for val, bound in checks.values())):
        raise AssertionError("the loaded DenseNet programs disagree with the eager calls")
    out = {"export_s": export_s}
    for what, call in (("forward-only", lambda: fwd.call(x)),
                       ("fwd+explain", lambda: program.call(x))):
        ms, calls, host, _ = windowed(call)
        say(f"densenet serving loaded {what} (blocks {SERVE_DENSENET_BLOCKS}): "
            f"{BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms; one "
            f"window of {calls} calls; host {host:.2f} ms) [{CARD}]")
        out[what] = BATCH / ms * 1e3
    return out


def densenet_train(net):
    """Trainer.fit of the densenet_121 Experiment (its own recipe: Adam 1e-4
    with the 90-epoch cosine, AGC, UniformOffLabels BCE; bf16 amp) at batch
    64 for TRAIN_STEPS steps on one repeated batch: the first of its train
    loader over the synthetic tree (seed 0), so that the net learns the
    tree's classes. It trains into the Experiment's own directory, from
    which the train command resumes. Then the step's launches, its time over
    TRAIN_WINDOW steps in a row, the host's issue time and the peak memory."""
    exp = Experiment(*DENSENET_EXPERIMENT)
    datamodule = exp.get_datamodule()
    datamodule.setup("fit")
    batches = iter(datamodule.train_dataloader(seed=0))
    first = next(batches)
    batches.close()  # stops the loader's threads
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in first.items()}
    criterion = RecordedLoss(exp.config["criterion"])
    exp.config = dict(exp.config, criterion=criterion)
    t0 = time.perf_counter()
    trainer = Trainer(exp, {"amp": True})
    state, counts = counted(lambda: trainer.fit(net, RepeatedBatch(batch, TRAIN_STEPS),
                                                max_epochs=1))
    fit_s = time.perf_counter() - t0
    evals = 2  # the initial and the epoch's validation, one batch each
    say(f"densenet train: Trainer.fit of {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, bf16 amp, "
        f"took {fit_s:.1f} s; launches {counts}")
    check_counts("densenet Trainer.fit", counts,
                 scaled_counts(DENSENET_FORWARD_COUNTS, TRAIN_STEPS + evals))
    losses = [float(v) for v in criterion.losses]
    say("densenet train loss per 5 steps: " + ", ".join(
        f"step {i}: {losses[i]:.6f}" for i in range(0, len(losses), 5))
        + f", step {len(losses) - 1}: {losses[-1]:.6f}")
    if (len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses)
            or not sum(losses[-5:]) < sum(losses[:5])):
        raise AssertionError(f"DenseNet train losses are not finite and falling: {losses}")
    if state.step != TRAIN_STEPS or trainer.ckpt.available_checkpoints() != [0]:
        raise AssertionError("the DenseNet fit did not take its steps or save its checkpoint")

    step = steps_lib.make_train_step(criterion, 1e-4, use_agc=True, amp=True)
    step(state, batch)  # warm-up
    _, per_step = counted(lambda: step(state, batch))
    say(f"densenet train: launches per train step {per_step}")
    check_counts("densenet train step", per_step, DENSENET_FORWARD_COUNTS)
    torch.cuda.reset_peak_memory_stats()
    host = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_WINDOW):
        t0 = time.perf_counter()
        step(state, batch)
        host.append(1e3 * (time.perf_counter() - t0))
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / TRAIN_WINDOW
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"densenet train step: {TRAIN_BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per step of "
        f"{TRAIN_BATCH}, one window of {TRAIN_WINDOW} steps; the host issues a step in "
        f"{statistics.median(host):.2f} ms (median; {min(host):.2f}-{max(host):.2f}); peak "
        f"memory {peak_gb:.1f} GB) [{CARD}]")
    if not all(math.isfinite(float(p.detach().float().sum())) for p in state.model.parameters()):
        raise AssertionError("DenseNet parameters are not finite after training")
    return {"step_img_s": TRAIN_BATCH / ms * 1e3, "step_ms": ms, "peak_gb": peak_gb}


def phase_densenet(x2, stream_rate, worst, exp_root):
    """Phase 10: the full-width DenseNet-121 of the densenet_121 recipe
    (random init from SEED, gamma-calibrated). Returns the DenseNet keys of
    K2's and K3's rows of the kernels line."""
    t0 = time.perf_counter()
    net = build_bcosified_densenet(Experiment(*DENSENET_EXPERIMENT).model_config, seed=SEED)
    mag = calibrate(net, x2[:1])
    say(f"densenet: built DenseNet-121 and calibrated its BN gammas in "
        f"{time.perf_counter() - t0:.1f} s: pre-logit magnitude {mag:.3g} on the probe")
    check_densenet_kernels(worst)
    launches = densenet_launches(net.model, BATCH, SIZE)
    per_shape = collections.Counter(launches)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = time_shapes(per_shape, stream_rate, gen, tag="densenet ")
    densenet_parity(net, x2)
    rates = densenet_throughput(net, x2)
    served = densenet_serving(x2)
    trained = densenet_train(net)
    cli_round_trip(DENSENET_EXPERIMENT, exp_root, DENSENET_FORWARD_COUNTS,
                   DENSENET_FORWARD_COUNTS["bcos_matmul_fwd"], ("last",), tag="densenet")
    say(f"densenet summary: fwd+explain {rates['fwd+explain']['img_s']:.1f} img/s, forward-only "
        f"{rates['forward-only']['img_s']:.1f}; loaded fwd+explain {served['fwd+explain']:.1f}, "
        f"forward-only {served['forward-only']:.1f} (blocks {SERVE_DENSENET_BLOCKS}); train step "
        f"{trained['step_img_s']:.1f} img/s "
        f"(peak {trained['peak_gb']:.1f} GB); export {served['export_s']:.1f} s [{CARD}]")
    keys = {}
    for name in ("bcos_matmul_fwd", "bcos_conv1x1_bwd_explain"):
        r = rows[name]
        say(f"densenet {name} per fwd+explain call ({DENSENET_EXPLAIN_COUNTS[name]} launches): "
            f"{r['ms']:.4f} ms; bound {1e3 * r['bound_s']:.4f} ms at the data-sheet rate, "
            f"{1e3 * r['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} "
            f"GB/s; plain {r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms [{CARD}]")
        keys[name] = {"densenet_launches": DENSENET_EXPLAIN_COUNTS[name],
                      "densenet_ms": r["ms"], "densenet_bound_ms": 1e3 * r["bound_s"],
                      "densenet_plain_ms": r["plain_ms"], "densenet_library_ms": r["library_ms"]}
    return keys


# --------------------------------------------------------------------------
# 11: CLIP-RN50
# --------------------------------------------------------------------------
CLIP_NAME = "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification"
CLIP_EXPERIMENTS = {"pooled": ("ImageNet", "clip_bcosification", CLIP_NAME),
                    "unpool": ("ImageNet", "clip_bcosification", CLIP_NAME + "_attnUnpool")}
# (label, M, K, N, relu, eps_outside) at batch 128, 224x224: conv1 of
# layer1's first block and of layer2's (the last 1x1 at 56x56), layer2's
# conv3 after its avg-pool, layer3's downsample, a layer4 conv3 (K2's split
# path, Cout 2048) and the attn-unpool c_proj (the B-cos linear)
CLIP_CHECK_SHAPES = [
    ("clip layer1_0.conv1", 401408, 64, 64, True, False),
    ("clip layer2_0.conv1", 401408, 256, 128, True, False),
    ("clip layer2_0.conv3", 100352, 128, 512, False, False),
    ("clip layer3_0.downsample", 25088, 512, 1024, False, False),
    ("clip layer4_1.conv3", 6272, 512, 2048, False, False),
    ("clip attnpool.c_proj", 6272, 2048, 1024, False, True),
]
CLIP_1X1 = 36  # conv1 and conv3 of the 16 bottlenecks, the 4 downsamples


def clip_counts(unpool, explain):
    """Launches of one encode (the module forward: K3 at every 1x1 conv,
    and at the B-cos c_proj when unpooled) or one text-grounded explanation
    (K1 and K2 at every 1x1; the unpooled c_proj adds one K3 and one K2)."""
    if explain:
        return {"bcos_conv1x1_fwd": CLIP_1X1, "bcos_conv1x1_bwd_explain": CLIP_1X1 + unpool,
                "bcos_matmul_fwd": int(unpool), "stream_add": 0}
    return {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
            "bcos_matmul_fwd": CLIP_1X1 + unpool, "stream_add": 0}


def clip_launches(net, batch, size, explain):
    """[(kernel, M, K, N, relu[, eps_outside])] of every launch of one encode
    or one text-grounded explanation (``clip_counts``), the 1x1 shapes read
    from forward hooks (``k3_shapes``)."""
    convs = k3_shapes(net.model, batch, size)
    pool = net.model.attnpool
    linear = []
    if pool.attn_unpool:
        k, n = pool.c_proj.weight.shape
        linear = [("bcos_matmul_fwd", convs[-1][1], k, n, False, True)]
        if explain:
            linear.append(("bcos_conv1x1_bwd_explain", convs[-1][1], k, n, False, True))
    if not explain:
        return [("bcos_matmul_fwd", m, k, n, False) for _, m, k, n in convs] + linear
    out = []
    for name, m, k, n in convs:
        relu = name.endswith("conv1")
        out += [("bcos_conv1x1_fwd", m, k, n, relu), ("bcos_conv1x1_bwd_explain", m, k, n, relu)]
    return out + linear


def check_clip_kernels(worst):
    """K1 (at the convs), K2 and K3 against their plain versions at
    CLIP_CHECK_SHAPES, both dtypes, phase 3's bounds: K2 as the CLIP pass
    calls it (the BN's mult, and the mask at a conv1; at c_proj no mult and
    the linear norm, eps_outside), K3 with both eps_outside values."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for label, m, k, n, relu, linear in CLIP_CHECK_SHAPES:
            x, wt, mult, add, ct = operands(m, k, n, dtype, gen)
            eps = LINEAR_NORM_EPS if linear else 1e-6
            a = k12.conv1x1_fwd(x, wt, mult, add, relu=True) if relu else None
            mu = None if linear else mult
            kw = dict(relu=relu, eps=eps, eps_outside=linear)
            results = [
                ("bcos_conv1x1_bwd_explain", " eps_outside" if linear else "",
                 k12.conv1x1_bwd_explain(x, wt, ct, a, mu, **kw),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct),
                                               None if a is None else ref(a), mu, **kw)),
            ] + [("bcos_matmul_fwd", " eps_outside" if e else "",
                  k3.bcos_matmul_fwd(x, wt, eps=eps, eps_outside=e),
                  k3.bcos_matmul_fwd_plain(ref(x), ref(wt), eps=eps, eps_outside=e))
                 for e in (False, True)]
            if not linear:
                results.append(("bcos_conv1x1_fwd", "",
                                k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                                k12.conv1x1_fwd_plain(ref(x), ref(wt), mult, add, relu=relu)))
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, label, dtype, got, want)
            del x, wt, ct, a, results


def _text_direction(dim, seed, device):
    """A unit text embedding made from ``seed``."""
    t = torch.randn(dim, generator=torch.Generator().manual_seed(seed))
    return (t / t.norm()).to(device)


def clip_parity(net, x2, head):
    """fp32, 2 images, the text-grounded explanation: the fast pass on the
    GPU against the CPU (scores within 1e-4; W with PyTorch's own CUDA convs
    within ten times the CPU's spread under 1e-7 relative input noise, with
    cuDNN's within phase 4's 1e-3, as phase 10 holds them), and the port's
    autograd through the module forward against the fast pass on the GPU
    (scores 1e-4, W ten times that spread). Unlike ResNet-50's, the module
    path does not share the fast pass's kernels: it runs each 1x1 conv on
    K3 and its BN apart, where the pass runs K1, and at full depth that
    rounding moves W by about one spread (~1e-4; PERF.md)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = x2.device
    t = _text_direction(net.model.attnpool.c_proj.features, SEED + 15, dev)
    sg, wg = fast_clip.fast_text_dlw(net, x2, t, device=dev)
    xx = x2.clone().requires_grad_(True)
    sm = fast_clip.text_score_head(net(xx, explain=True), t)
    (wm,) = torch.autograd.grad(sm.sum(), xx)
    torch.backends.cudnn.enabled = False
    try:
        _, w_native = fast_clip.fast_text_dlw(net, x2, t, device=dev)
    finally:
        torch.backends.cudnn.enabled = True
    cpu = copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    sc, wc = fast_clip.fast_text_dlw(cpu, x2.cpu(), t.cpu(), device="cpu")
    cpu_s = time.perf_counter() - t0
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 16))
    _, wn = fast_clip.fast_text_dlw(cpu, x2.cpu() * (1 + 1e-7 * noise), t.cpu(), device="cpu")
    spread = rel(wn, wc)
    err, err_native = rel(wg, wc), rel(w_native, wc)

    def max_rel(a, b):
        return float((a.double().cpu() - b.double().cpu()).abs().max() / b.double().abs().max())

    checks = {
        "W gpu-kernels (torch convs) vs cpu-plain": (err_native, 10 * spread),
        "W gpu-kernels (cudnn convs) vs cpu-plain": (err, 1e-3),
        "W module-path vs fast-path (gpu)": (rel(wm, wg), 10 * spread),
        "scores gpu vs cpu (max rel)": (max_rel(sg, sc), 1e-4),
        "scores module vs fast (max rel)": (max_rel(sm.detach(), sg), 1e-4),
    }
    say(f"clip {head} parity W on the cpu under 1e-7 relative input noise: {spread:.3e}; gpu "
        f"vs cpu {err_native:.3e} = {err_native / spread:.2f} x that spread with PyTorch's CUDA "
        f"convs, {err:.3e} = {err / spread:.2f} x with cuDNN's; scores {sg.tolist()}; cpu pass "
        f"took {cpu_s:.1f} s")
    for key, (val, bound) in checks.items():
        say(f"clip {head} parity {key}: {val:.3e} (bound {bound:.3e})")
    if any(not val <= bound for val, bound in checks.values()):
        raise AssertionError(f"CLIP {head} parity failed")
    if not all(torch.isfinite(v).all() for v in (sg, wg)) or wg.shape != x2.shape:
        raise AssertionError(f"CLIP {head} outputs are not finite or mis-shaped")
    return t


def clip_throughput(net, x, t, unpool, head):
    """Encode and text-grounded fwd+explain images/s at batch 128, bf16, each
    with its launch counts, host issue time and peak memory."""
    def encode():
        with torch.no_grad():
            return net(x)

    def text_explain():
        return fast_clip.fast_text_dlw(net, x, t, device=x.device)

    out = {}
    for what, fn, explain_ in (("encode", encode, False), ("fwd+explain", text_explain, True)):
        fn()
        result, counts = counted(fn)
        check_counts(f"clip {head} {what}", counts, clip_counts(unpool, explain_))
        outs = result if isinstance(result, tuple) else (result,)
        if not all(torch.isfinite(v).all() for v in outs):
            raise AssertionError(f"CLIP {head} {what}: outputs are not finite")
        ms, calls, host, peak_gb = windowed(fn)
        say(f"clip {head} throughput {what}: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per batch "
            f"of {BATCH}, one window of {calls} calls; the host issues one call in {host:.2f} "
            f"ms; peak memory of one call {peak_gb:.2f} GB; launches {counts}) [{CARD}]")
        out[what] = {"img_s": BATCH / ms * 1e3, "ms": ms, "host_ms": host, "peak_gb": peak_gb}
    return out


ZEROSHOT_PARITY_CLASSES = 1  # the fp32 classifier's classes held GPU against CPU


def clip_zeroshot(nets, device):
    """The zero-shot classifier of a random-init CLIP-RN50 text tower (from
    SEED) over the 1000 ImageNet classes x 80 templates in bf16 (tokenize
    and tower timed apart, then the whole ``zeroshot_classifier`` call):
    [1024, 1000], finite, unit-norm columns; 8 classes in fp32 on the GPU
    against the CPU (1e-4); then ``zeroshot_evaluate`` of each head over
    the val split of the synthetic tree through the Experiment's data
    module (the CLIP eval preset), with its K3 launches per batch."""
    texts = [zeroshot.format_template(t, c) for c in imagenet_classes for t in imagenet_templates]
    t0 = time.perf_counter()
    tokens = torch.from_numpy(tokenize(texts))
    tok_s = time.perf_counter() - t0
    cfg = clip_rn50_config()
    text = build_clip_text(None, cfg, seed=SEED, device=device)
    text16 = copy.deepcopy(text).to(torch.bfloat16)
    chunk = 32 * len(imagenet_templates)
    with torch.no_grad():
        text16(tokens[:chunk])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(texts), chunk):
            text16(tokens[i:i + chunk])
        torch.cuda.synchronize()
    tower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w = zeroshot.zeroshot_classifier(text16, imagenet_classes, imagenet_templates)
    torch.cuda.synchronize()
    classifier_s = time.perf_counter() - t0
    norms = w.norm(dim=0)
    say(f"clip zero-shot: tokenized {len(texts)} prompts in {tok_s:.2f} s (host); the bf16 text "
        f"tower over them in {tower_s:.2f} s ({len(texts) / tower_s:.0f} prompts/s); "
        f"zeroshot_classifier {classifier_s:.2f} s -> {tuple(w.shape)}, column norms "
        f"{float(norms.min()):.6f}-{float(norms.max()):.6f} [{CARD}]")
    if (tuple(w.shape) != (cfg["embed_dim"], len(imagenet_classes))
            or not bool(torch.isfinite(w).all()) or float((norms - 1).abs().max()) > 1e-5):
        raise AssertionError("the zero-shot classifier is not [embed_dim, classes] finite unit "
                             "columns")
    classes = imagenet_classes[:ZEROSHOT_PARITY_CLASSES]
    w_gpu = zeroshot.zeroshot_classifier(text, classes, imagenet_templates)
    t0 = time.perf_counter()
    w_cpu = zeroshot.zeroshot_classifier(copy.deepcopy(text).to("cpu"), classes,
                                         imagenet_templates)
    err = rel(w_gpu, w_cpu)
    say(f"clip zero-shot fp32, {len(classes)} classes x 80 templates, gpu vs cpu: {err:.3e} "
        f"(bound 1e-4; "
        f"the cpu took {time.perf_counter() - t0:.1f} s)")
    if not err <= 1e-4:
        raise AssertionError("the zero-shot classifier on the GPU disagrees with the CPU")
    del text, text16
    out = {"tokenize_s": tok_s, "tower_s": tower_s, "classifier_s": classifier_s}
    for head, (net, cos_power) in nets.items():
        dm = Experiment(*CLIP_EXPERIMENTS[head]).get_datamodule()
        dm.setup("test")
        loader = dm.val_dataloader()

        def encode(images):
            return net(torch.cat([images, 1.0 - images], dim=-1).to(torch.bfloat16))

        t0 = time.perf_counter()
        acc, counts = counted(lambda: zeroshot.zeroshot_evaluate(encode, loader, w.to(
            torch.bfloat16), cos_power=cos_power))
        batches = len(loader)  # the CLIP config's batch of 64
        check_counts(f"clip {head} zeroshot_evaluate", counts,
                     scaled_counts(clip_counts(head == "unpool", False), batches))
        say(f"clip {head} zeroshot_evaluate over {ENTRY_VAL} val JPEGs ({batches} batches, "
            f"cos_power {cos_power}): top-1 {acc['acc1']:.4f}, top-5 {acc['acc5']:.4f} in "
            f"{time.perf_counter() - t0:.1f} s; launches {counts}")
        out[f"{head}_acc1"] = acc["acc1"]
    return out


SERVE_CLIP_LAYERS = (1, 1, 1, 1)  # the exported CLIP-RN50's bottlenecks per stage


def clip_serving(x2, x, t):
    """The pooled tower cut to SERVE_CLIP_LAYERS (full width, random init
    from SEED, gamma-calibrated: the export's time is its traced ops): its
    text-grounded explanation and forward exported, saved to bytes and
    loaded back: at batch 128, bf16, equal to the eager calls (1e-6
    relative: the same ops and kernels on the same inputs) with the same
    launch counts; the loaded explanation's images/s."""
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_visual

    cfg = {**clip_rn50_config(), "vision_layers": SERVE_CLIP_LAYERS}
    net = build_bcosified_clip_visual(Experiment(*CLIP_EXPERIMENTS["pooled"]).model_config,
                                      None, cfg, seed=SEED)
    calibrate(net, x2[:1])
    explain_counts = kernel_counts(clip_launches(net, 1, SIZE, True))
    forward_counts = kernel_counts(clip_launches(net, 1, SIZE, False))
    t0 = time.perf_counter()
    blob = serving.export_text_explain(net, embed_dim=t.shape[0], input_size=SIZE,
                                       dtype=torch.bfloat16, device=x.device)
    blob_fwd = serving.export_forward(net, input_size=SIZE, dtype=torch.bfloat16,
                                      device=x.device)
    program, fwd = serving.load_serialized(blob), serving.load_serialized(blob_fwd)
    export_s = time.perf_counter() - t0
    say(f"clip serving (layers {SERVE_CLIP_LAYERS}): exported and loaded both programs in "
        f"{export_s:.1f} s "
        f"({len(blob) / 1e6:.1f} MB and {len(blob_fwd) / 1e6:.1f} MB)")
    t16 = t.to(torch.bfloat16)
    (s, w), counts = counted(lambda: program.call(x, t16))
    check_counts("clip loaded text explain", counts, explain_counts)
    feats, counts_f = counted(lambda: fwd.call(x))
    check_counts("clip loaded forward", counts_f, forward_counts)
    es, ew = fast_clip.fast_text_dlw(net, x, t16, device=x.device)
    with torch.no_grad():
        ef = net(x)
    checks = {"scores loaded vs eager (rel)": (rel(s.float(), es.float()), 1e-6),
              "W loaded vs eager (rel)": (rel(w.float(), ew.float()), 1e-6),
              "features loaded vs eager forward (rel)": (rel(feats.float(), ef.float()), 1e-6)}
    for key, (val, bound) in checks.items():
        say(f"clip serving {key}: {val:.3e} (bound {bound:.0e})")
    if any(not val <= bound for val, bound in checks.values()):
        raise AssertionError("the loaded CLIP programs disagree with the eager calls")
    ms, calls, host, _ = windowed(lambda: program.call(x, t16))
    say(f"clip serving loaded text fwd+explain (layers {SERVE_CLIP_LAYERS}): "
        f"{BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms; one "
        f"window of {calls} calls; host {host:.2f} ms) [{CARD}]")
    return {"export_s": export_s, "loaded_img_s": BATCH / ms * 1e3}


def phase_clip(x2, stream_rate, worst):
    """Phase 11: the CLIP-RN50 student of the clip_bcosification recipe, pooled
    and attn-unpool (random init from SEED, gamma-calibrated), on the card.
    Returns the CLIP keys of K1's, K2's and K3's rows of the kernels line."""
    check_clip_kernels(worst)
    nets, rates = {}, {}
    for head, experiment in CLIP_EXPERIMENTS.items():
        t0 = time.perf_counter()
        exp = Experiment(*experiment)
        net = exp.get_model()
        mag = calibrate(net, x2[:1])
        say(f"clip {head}: built {experiment[2]} and calibrated its BN gammas in "
            f"{time.perf_counter() - t0:.1f} s: feature magnitude {mag:.3g} on the probe")
        t = clip_parity(net, x2, head)
        x = _batch128(x2, SEED + 17)
        rates[head] = clip_throughput(net, x, t, head == "unpool", head)
        nets[head] = (net, int(exp.model_config.get("cos_power", 1)) if head == "unpool" else 0)
    pooled = nets["pooled"][0]
    served = clip_serving(x2, _batch128(x2, SEED + 18),
                          _text_direction(pooled.model.attnpool.c_proj.features, SEED + 19,
                                          x2.device))
    zs = clip_zeroshot(nets, x2.device)
    unpool = nets["unpool"][0]
    gen = torch.Generator(device=x2.device).manual_seed(SEED + 20)
    rows = {what: time_shapes(collections.Counter(clip_launches(unpool, BATCH, SIZE, explain_)),
                              stream_rate, gen, tag=f"clip {what} ")
            for what, explain_ in (("encode", False), ("explain", True))}
    say(f"clip summary: pooled encode {rates['pooled']['encode']['img_s']:.1f} img/s, text "
        f"fwd+explain {rates['pooled']['fwd+explain']['img_s']:.1f}; attn-unpool encode "
        f"{rates['unpool']['encode']['img_s']:.1f}, text fwd+explain "
        f"{rates['unpool']['fwd+explain']['img_s']:.1f}; loaded text fwd+explain "
        f"{served['loaded_img_s']:.1f} (layers {SERVE_CLIP_LAYERS}); export "
        f"{served['export_s']:.1f} s; zero-shot classifier "
        f"{zs['classifier_s']:.2f} s [{CARD}]")
    keys = {}
    for what, explain_ in (("encode", False), ("explain", True)):
        counts = clip_counts(True, explain_)
        for name, r in rows[what].items():
            say(f"clip {name} per attn-unpool {what} ({counts[name]} launches): {r['ms']:.4f} ms; "
                f"bound {1e3 * r['bound_s']:.4f} ms at the data-sheet rate, "
                f"{1e3 * r['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} "
                f"GB/s; plain {r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms "
                f"[{CARD}]")
            keys.setdefault(name, {}).update({
                f"clip_{what}_launches": counts[name], f"clip_{what}_ms": r["ms"],
                f"clip_{what}_bound_ms": 1e3 * r["bound_s"],
                f"clip_{what}_plain_ms": r["plain_ms"],
                f"clip_{what}_library_ms": r["library_ms"]})
    return keys, {head: net for head, (net, _) in nets.items()}


# --------------------------------------------------------------------------
# 12: CLIP-RN50 knowledge distillation
# --------------------------------------------------------------------------
CC3M_EXPERIMENT = ("CC3M", "clip_bcosification",
                   "resnet_50_clip_b2_noBias_randomResizedCrop_sigLip_kd_CC3M_bcosification")
KD_BATCH, KD_STEPS, KD_WINDOW = 64, 20, 10
CC3M_DISTINCT, CC3M_PAIRS, CC3M_LOADER_BATCHES = 4, 70, 10
CC3M_SEED_STEPS = 5  # the CC3M Experiment's first epoch, from the calibrated student
# one fp32 KD step, GPU against CPU: the loss within 1e-5 relative, every
# student gradient within ten times the CPU's own spread under 1e-7 relative
# input noise (as phases 9-11 hold full-depth gradients and W)
KD_LOSS_BOUND = 1e-5


def kd_counts(unpool):
    """Launches of one KD train step: the student's train forward runs K3 at
    every 1x1 conv (and at the unpooled c_proj, eps_outside), as one encode
    does; the teacher has no B-cos layer; the backward is plain matmuls."""
    return clip_counts(unpool, False)


def check_kd_kernels(students, worst):
    """K3 against its plain version at every distinct shape of one KD train
    step at batch 64 (both heads: the unpooled c_proj with the linear norm,
    eps_outside), both dtypes, phase 3's bounds."""
    shapes = sorted({key for net in students.values()
                     for key in clip_launches(net, KD_BATCH, SIZE, False)})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for name, m, k, n, _, *linear in shapes:
            x, wt, *_ = operands(m, k, n, dtype, gen)
            kw = dict(eps=LINEAR_NORM_EPS if any(linear) else 1e-6, eps_outside=any(linear))
            got = k3.bcos_matmul_fwd(x, wt, **kw)
            want = k3.bcos_matmul_fwd_plain(ref(x), ref(wt), **kw)
            torch.cuda.synchronize()
            _check(worst, name, " eps_outside" if any(linear) else "",
                   f"kd M={m} K={k} N={n}", dtype, got, want)
            del x, wt, got, want
    return len(shapes)


def param_hash(module) -> str:
    h = hashlib.sha256()
    for p in module.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def recorded_kd():
    """While it lasts: the loss of every KD train step (``kd_loss`` called with
    gradient on) and every teacher that ``clip.load.load`` hands out."""
    record = types.SimpleNamespace(losses=[], teachers=[])
    load_module = importlib.import_module("bcosification_tpu_torch.clip.load")
    loss_fn, load_fn = kd_lib.kd_loss, load_module.load

    def kd_loss(*args, **kwargs):
        loss = loss_fn(*args, **kwargs)
        if torch.is_grad_enabled():
            record.losses.append(loss.detach())
        return loss

    def load(*args, **kwargs):
        out = load_fn(*args, **kwargs)
        record.teachers.append(out[0])
        return out

    kd_lib.kd_loss, load_module.load = kd_loss, load
    try:
        yield record
    finally:
        kd_lib.kd_loss, load_module.load = loss_fn, load_fn


@contextlib.contextmanager
def without_zeroshot():
    """No zero-shot datasets while it lasts (IMAGENET_PATH and DATA_ROOT
    unset for the port), so that a KD epoch skips its zero-shot."""
    old = settings.IMAGENET_PATH, settings.DATA_ROOT
    settings.IMAGENET_PATH = settings.DATA_ROOT = None
    try:
        yield
    finally:
        settings.IMAGENET_PATH, settings.DATA_ROOT = old


def kd_fit(head, net, batch):
    """Trainer.fit of the ImageNet KD Experiment (-> fit_kd) for one epoch of
    KD_STEPS steps on one repeated batch, bf16 amp, then a resume for one
    step: the losses, the launches, the checkpoints, the teacher frozen and
    the student moved. Returns the teacher."""
    unpool = head == "unpool"
    exp = Experiment(*CLIP_EXPERIMENTS[head])
    data = RepeatedBatch(batch, KD_STEPS)
    with without_zeroshot(), recorded_kd() as rec:
        t0 = time.perf_counter()
        trainer = Trainer(exp, {"amp": True})
        state, counts = counted(lambda: trainer.fit(net, data, max_epochs=1))
        fit_s = time.perf_counter() - t0
        teacher = rec.teachers[0]
        teacher_hash = param_hash(teacher)
        check_counts(f"kd {head} Trainer.fit", counts,
                     scaled_counts(kd_counts(unpool), KD_STEPS + 1))  # + one val batch
        resumed = Trainer(exp, {"amp": True}).fit(net, data, max_epochs=2, fast_dev_run=True)
    losses = [float(v) for v in rec.losses]
    history = trainer.metrics.history
    say(f"kd {head} Trainer.fit (-> fit_kd) of {KD_STEPS} steps at batch {KD_BATCH}, bf16 amp: "
        f"{fit_s:.1f} s; launches {counts}; loss per 5 steps: " + ", ".join(
            f"step {i}: {losses[i]:.6f}" for i in range(0, KD_STEPS, 5))
        + f", step {KD_STEPS - 1}: {losses[KD_STEPS - 1]:.6f}; falling: "
        f"{sum(losses[KD_STEPS - 5:KD_STEPS]) < sum(losses[:5])}")
    say(f"kd {head} metrics: {json.dumps(history)}")
    if len(losses) != KD_STEPS + 1 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"kd {head}: the losses are not finite: {losses}")
    if state.step != KD_STEPS or resumed.step != KD_STEPS + 1:
        raise AssertionError(f"kd {head}: steps {state.step}, {resumed.step} after the resume")
    val = {e: v for e, v in exp.load_metrics()["val_loss"]}
    best = trainer.ckpt.resolve("best")
    checkpoints = trainer.ckpt.available_checkpoints()
    same_teacher = rec.teachers[-1] is not teacher and param_hash(rec.teachers[-1]) == teacher_hash
    frozen = param_hash(teacher) == teacher_hash and same_teacher
    moved = param_hash(resumed.model) != param_hash(net)
    say(f"kd {head} resume: one step from epoch 0 (step {resumed.step}); checkpoints "
        f"{checkpoints}; val_loss per epoch {val}; best {best} (the minimum: "
        f"{best == min(val, key=val.get)}); teacher hash after {KD_STEPS} steps {teacher_hash}, "
        f"equal to a fresh load's: {frozen}; "
        f"student hash {param_hash(net)} -> {param_hash(resumed.model)}, moved: {moved}")
    if checkpoints != [0, 1] or best != min(val, key=val.get) or not frozen or not moved:
        raise AssertionError(f"kd {head}: checkpoints, best, teacher or student wrong")
    return teacher


def kd_window(head, net, teacher, batch, counts=None):
    """One KD train step's launches (``counts``, default kd_counts), then its
    ms, img/s, host issue ms and peak memory over KD_WINDOW steps in a row
    after a warm-up step, the card's busy time and top kernels, and the
    teacher's forward alone."""
    unpool = head.endswith("unpool")
    opt = OptimizerFactory("Adam", 1e-4, bcosify=True, b_opt=False)
    state = steps_lib.create_train_state(net, opt.create)
    step = kd_lib.make_kd_train_step(teacher, 1e-4, cos_power=2 if unpool else 0, amp=True)
    step(state, batch)
    _, per_step = counted(lambda: step(state, batch))
    check_counts(f"kd {head} train step", per_step, counts or kd_counts(unpool))
    torch.cuda.reset_peak_memory_stats()
    host = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(KD_WINDOW):
        t0 = time.perf_counter()
        step(state, batch)
        host.append(1e3 * (time.perf_counter() - t0))
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / KD_WINDOW
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    x3 = ((batch["image"] - torch.tensor(kd_lib.CLIP_MEAN, device="cuda"))
          / torch.tensor(kd_lib.CLIP_STD, device="cuda")).to(torch.bfloat16)

    def teacher_forward():
        with torch.no_grad():
            return teacher(x3)

    teacher_ms = window_ms(teacher_forward, KD_WINDOW)
    out = {"ms": ms, "img_s": KD_BATCH / ms * 1e3, "host_ms": statistics.median(host),
           "peak_gb": peak_gb, "teacher_ms": teacher_ms, "launches": per_step}
    say(f"kd {head} train step: {out['img_s']:.1f} img/s ({ms:.2f} ms per step of {KD_BATCH}, "
        f"one window of {KD_WINDOW} steps; the host issues a step in {out['host_ms']:.2f} ms "
        f"(median; {min(host):.2f}-{max(host):.2f}); peak memory {peak_gb:.1f} GB; the bf16 "
        f"teacher forward alone {teacher_ms:.2f} ms; launches {per_step}) [{CARD}]")
    busy, top = device_profile(lambda: step(state, batch), 3)
    if busy is None:
        say(f"kd {head} train step: the profiler trace holds no device time; card time not "
            "measured")
    else:
        out["busy_ms"] = busy
        say(f"kd {head} train step: the card is busy {busy:.2f} of {ms:.2f} ms per step (idle "
            f"share {1 - busy / ms:.1%}; torch.profiler over 3 steps) [{CARD}]")
        for name, kms in top:
            say(f"kd {head} train step card time: {kms:8.3f} ms per step  {name[:100]}")
    if not all(math.isfinite(float(p.detach().float().sum())) for p in state.model.parameters()):
        raise AssertionError(f"kd {head}: parameters are not finite after training")
    return out


def _kd_grads(student, teacher, images, cos_power):
    """(loss, {name: gradient}, BN running_var) in f64 on the CPU of one
    train-mode KD loss of a copy of ``student``."""
    s = copy.deepcopy(student).requires_grad_(True)
    t_feat, s_out = kd_lib.kd_forward_features(s, teacher, images, train=True)
    loss = kd_lib.kd_loss(s_out, t_feat, 10.0, -10.0, cos_power)
    loss.backward()
    rv = torch.cat([b.double().cpu() for n, b in s.named_buffers() if n.endswith("running_var")])
    return (float(loss.detach()), {n: p.grad.double().cpu() for n, p in s.named_parameters()},
            rv)


def kd_step_parity(student, teacher, images, cos_power):
    """One fp32 KD loss and backward of ``student`` (train mode) on the GPU
    against the same on a CPU copy: {check: (value, bound)} for the loss
    (KD_LOSS_BOUND relative); the worst gradient leaf (its distance over the
    largest leaf's norm), within ten times the CPU's own spread under 1e-7
    relative input noise; the BN running_var after the forward, within ten
    times the CPU's own spread in it under that noise or under the batch in
    reverse order (the same statistics summed in another order: the
    one-pass f32 variance E[x^2] - E[x]^2 loses digits where the mean is
    large)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss_g, grads_g, rv_g = _kd_grads(student, teacher, images, cos_power)
    cpu_s, cpu_t, x = (copy.deepcopy(student).to("cpu"), copy.deepcopy(teacher).to("cpu"),
                       images.cpu())
    loss_c, grads_c, rv_c = _kd_grads(cpu_s, cpu_t, x, cos_power)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(SEED + 22))
    _, grads_n, rv_n = _kd_grads(cpu_s, cpu_t, x * (1 + 1e-7 * noise), cos_power)
    _, _, rv_r = _kd_grads(cpu_s, cpu_t, x.flip(0), cos_power)
    top = max(float(g.norm()) for g in grads_c.values())

    def worst(grads):
        return max(float((grads[n] - g).norm()) for n, g in grads_c.items()) / top

    spread = worst(grads_n)
    return {"loss": (abs(loss_g - loss_c) / abs(loss_c), KD_LOSS_BOUND),
            "gradient": (worst(grads_g), 10 * spread),
            "running_var": (rel(rv_g, rv_c), 10 * max(rel(rv_n, rv_c), rel(rv_r, rv_c)))}


def kd_parity(students, x2):
    """Phase 12 (f): kd_step_parity of the full-width pooled and attn-unpool
    students (fp32, 2 images) with the random-init teacher made from SEED."""
    teacher = build_clip_teacher_visual(None, clip_rn50_config(), seed=SEED)
    images = x2[..., :3].float().contiguous()
    for head, net in students.items():
        t0 = time.perf_counter()
        checks = kd_step_parity(net, teacher, images, 2 if head == "unpool" else 0)
        for key, (val, bound) in checks.items():
            say(f"kd {head} parity fp32 gpu vs cpu, {key}: {val:.3e} (bound {bound:.3e})")
        say(f"kd {head} parity took {time.perf_counter() - t0:.1f} s")
        if any(not val <= bound for val, bound in checks.values()):
            raise AssertionError(f"the KD step of the {head} tower on the GPU disagrees with "
                                 "the CPU")


def kd_cli(experiment, exp_root, counts, checkpoints, tag):
    """``train --fast_dev_run`` of a KD experiment in process (fp32), its
    launches, checkpoints and finite epoch metrics; returns its metrics."""
    exp = Experiment(*experiment)
    args = ["--dataset", experiment[0], "--base_network", experiment[1], "--experiment_name",
            experiment[2], "--fast_dev_run", "--base_directory", str(exp_root)]
    t0 = time.perf_counter()
    _, got = counted(lambda: train_cli.main(args))
    logged = exp.load_metrics()
    last = {k: v[-1] for k, v in logged.items()}
    say(f"kd {tag} train --experiment_name {experiment[2]} --fast_dev_run: "
        f"{time.perf_counter() - t0:.1f} s; checkpoints {exp.available_checkpoints()}; epoch "
        f"metrics {json.dumps(last)}; launches {got}")
    check_counts(f"kd {tag} train --fast_dev_run", got, counts)
    if exp.available_checkpoints() != checkpoints or not all(
            math.isfinite(v[1]) for v in last.values()):
        raise AssertionError(f"kd {tag}: checkpoints {exp.available_checkpoints()}, "
                             f"metrics {last}")
    return last


@contextlib.contextmanager
def synthetic_cc3m():
    """A synthetic CC3M tree (data/synthetic.py: CC3M_DISTINCT distinct train
    shards of CC3M_PAIRS JPEG + caption pairs of 500x375, linked to 332
    shards, and 2 val shards) in a temporary directory, with CC3M_PATH
    pointing at it while the context lasts."""
    old = settings.CC3M_PATH, os.environ.get("CC3M_PATH")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_cc3m_tree(tmp, CC3M_DISTINCT, CC3M_PAIRS, seed=SEED)
        say(f"kd cc3m: wrote 332 train shards ({CC3M_DISTINCT} distinct) and 2 val shards of "
            f"{CC3M_PAIRS} JPEG + caption pairs in {time.perf_counter() - t0:.1f} s")
        os.environ["CC3M_PATH"] = settings.CC3M_PATH = tmp
        try:
            yield tmp
        finally:
            settings.CC3M_PATH = old[0]
            if old[1] is None:
                os.environ.pop("CC3M_PATH", None)
            else:
                os.environ["CC3M_PATH"] = old[1]


def kd_cc3m(exp_root, student, batch):
    """Phase 12 (g): the CC3M train loader alone (image mode, as fit_kd reads
    it); Trainer.fit of the CC3M KD Experiment for one epoch of
    CC3M_SEED_STEPS steps on one repeated batch from the calibrated pooled
    ``student`` (a conversion-time student contracts to ~0 in eval mode, and
    phase 16 reads this experiment's features); then ``train`` of the CC3M
    KD config with --fast_dev_run, twice (each resumes)."""
    with synthetic_cc3m():
        dm = Experiment(*CC3M_EXPERIMENT).get_datamodule()
        dm.setup("fit")
        loader = dm.train_dataloader(seed=SEED)
        loader.mode = "image"
        t0 = time.perf_counter()
        n = 0
        for i, batch in enumerate(loader):
            n += len(batch["key"])
            if i + 1 == CC3M_LOADER_BATCHES:
                break
        loader_s = time.perf_counter() - t0
        if n != CC3M_LOADER_BATCHES * dm.batch_size or batch["image"].shape != (
                dm.batch_size, SIZE, SIZE, 3):
            raise AssertionError(f"the CC3M loader gave {n} images, {batch['image'].shape}")
        say(f"kd cc3m train loader alone: {n / loader_s:.1f} img/s ({n} images in "
            f"{CC3M_LOADER_BATCHES} batches in {loader_s:.2f} s, the first after filling the "
            f"shuffle buffer of {loader.shuffle_buffer}; PIL decode in the calling thread on a "
            f"host with {os.cpu_count()} CPUs) [{CARD}]")
        # one train step and one val batch per run; no zero-shot data here
        with without_zeroshot():
            Trainer(Experiment(*CC3M_EXPERIMENT), {"amp": True}).fit(
                student, RepeatedBatch(batch, CC3M_SEED_STEPS), max_epochs=1)
            for checkpoints in ([0, 1], [0, 1, 2]):
                kd_cli(CC3M_EXPERIMENT, exp_root, scaled_counts(kd_counts(False), 2),
                       checkpoints, "cc3m")
    return n / loader_s


def phase_kd(students, x2, stream_rate, worst, exp_root):
    """Phase 12: CLIP knowledge distillation of the CLIP-RN50 student, pooled
    and attn-unpool, on the card (see the module docstring). Returns the KD
    keys of K3's row of the kernels line."""
    n_shapes = check_kd_kernels(students, worst)
    say(f"kd: K3 checked at the {n_shapes} distinct shapes of a KD train step at batch "
        f"{KD_BATCH}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    image = torch.rand((KD_BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    batch = {"image": image}
    steps = {}
    for head, net in students.items():
        teacher = kd_fit(head, net, batch)
        steps[head] = kd_window(head, net, teacher, batch)
        del teacher
    kd_parity(students, x2)
    unpool = students["unpool"]
    per_shape = collections.Counter(clip_launches(unpool, KD_BATCH, SIZE, False))
    row = time_shapes(per_shape, stream_rate, gen, tag="kd ")["bcos_matmul_fwd"]
    launches = steps["unpool"]["launches"]["bcos_matmul_fwd"]
    say(f"kd bcos_matmul_fwd per attn-unpool KD train step ({launches} launches): "
        f"{row['ms']:.4f} ms; bound {1e3 * row['bound_s']:.4f} ms at the data-sheet rate, "
        f"{1e3 * row['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} GB/s; "
        f"plain {row['plain_ms']:.4f} ms, torch.matmul {row['library_ms']:.4f} ms [{CARD}]")
    loader_img_s = kd_cc3m(exp_root, students["pooled"], batch)
    # the ImageNet KD config from the command, resuming from kd_fit's
    # checkpoints; with IMAGENET_PATH set its epoch ends with the zero-shot
    # over the val split (2 batches of 64), K3 in its encode
    last = kd_cli(CLIP_EXPERIMENTS["pooled"], exp_root, scaled_counts(kd_counts(False), 4),
                  [0, 1, 2], "imagenet")
    if "zeroshot_ImageNet_acc1" not in last:
        raise AssertionError("the ImageNet KD epoch logged no zeroshot_ImageNet_acc1")
    say(f"kd summary: train step pooled {steps['pooled']['img_s']:.1f} img/s, attn-unpool "
        f"{steps['unpool']['img_s']:.1f} img/s; teacher forward {steps['pooled']['teacher_ms']:.2f} "
        f"ms; CC3M loader {loader_img_s:.1f} img/s; zero-shot top-1 after the ImageNet KD epoch "
        f"{last['zeroshot_ImageNet_acc1'][1]:.4f} [{CARD}]")
    return {"kd_launches": launches, "kd_ms": row["ms"], "kd_bound_ms": 1e3 * row["bound_s"],
            "kd_plain_ms": row["plain_ms"], "kd_library_ms": row["library_ms"]}


# --------------------------------------------------------------------------
# 13: ViT-B/16
# --------------------------------------------------------------------------
VIT_NAME = "bcosifyv2_bcos_simple_vit_b_patch16_224"
VIT_EXPERIMENTS = {"default": ("ImageNet", "vit_bcosification", VIT_NAME),
                   "useBias_noGelu_gapReorder": ("ImageNet", "vit_bcosification",
                                                 VIT_NAME + "_useBias_noGelu_gapReorder")}
# launches of one fwd+explain of each (K3 and K2 at every bias-free B-cos
# linear: the patch embedding, to_out, linear1 and linear2 of the 12
# encoders, the head; with useBias to_out alone); a forward drops the K2s
VIT_LINEARS = {"default": 38, "useBias_noGelu_gapReorder": 12}
VIT_ROWS = BATCH * (SIZE // 16) ** 2  # 25088 token rows at batch 128
# (label, M, K, N) of ViT-B/16's bias-free B-cos linears at batch 128, 224x224
VIT_CHECK_SHAPES = [
    ("vit patch embedding", VIT_ROWS, 1536, 768),
    ("vit to_out", VIT_ROWS, 768, 768),
    ("vit linear1", VIT_ROWS, 768, 3072),  # K2's bf16 scratch route (Cout > 1024)
    ("vit linear2", VIT_ROWS, 3072, 768),
    ("vit head", BATCH, 768, 1000),
]


def vit_backbone(net):
    """The SimpleViT of a BcosifyNetwork, or ``net`` itself (vit_final)."""
    return net.model if isinstance(net, BcosifyNetwork) else net


def vit_logit_bias(net):
    """The bias of the logit layer (the wrapper's or the SimpleViT's; 0
    without one)."""
    if isinstance(net, BcosifyNetwork):
        return net.logit_bias
    return net.logit_layer.logit_bias if net.with_logit_layer else 0.0


def vit_launches(net, batch, size, explain):
    """[(kernel, M, K, N, relu, eps_outside)] of every launch of one forward
    (also one train step) or one fwd+explain of a B-cos SimpleViT: K3 (and
    K2) with the linear norm at each bias-free B-cos linear, in forward
    order (a standard ViT's plain linears launch none), and at each expert
    of a switch MoE (its slots: the capacity at these tokens); the tokens
    after the conv stem (3x3, padding 1) of a ViT-C."""
    m = vit_backbone(net)
    for conv in m.stem()[::3]:
        size = (size + 2 * conv.padding[0] - 3) // conv.stride[0] + 1
    rows = batch * (size // m.patch_size[0]) * (size // m.patch_size[1])
    shapes = [(m.to_patch_embedding_linear, rows)]
    for enc in m.encoders():
        shapes += [(enc.attn.to_out, rows), (enc.ff.linear1, rows)]
        moe = getattr(enc.ff, "moe2", None)
        if moe is None:
            shapes.append((enc.ff.linear2, rows))
        elif moe.b == 2:
            shapes += [((moe.in_features, moe.features), moe.capacity(rows))] * moe.num_experts
    shapes.append((m.linear_head_linear, rows if m.gap_reorder else batch))
    out = []
    for lin, r in shapes:
        if isinstance(lin, tuple) or (isinstance(lin, BcosLinear) and lin.bias is None):
            k, n = lin if isinstance(lin, tuple) else lin.weight.shape
            out.append(("bcos_matmul_fwd", r, k, n, False, True))
            if explain:
                out.append(("bcos_conv1x1_bwd_explain", r, k, n, False, True))
    return out


def vit_counts(net, explain):
    return kernel_counts(vit_launches(net, 1, SIZE, explain))


def check_vit_kernels(worst, shapes=VIT_CHECK_SHAPES):
    """K3 and K2 against their plain versions at ``shapes`` (label, M, K, N),
    both dtypes, phase 3's bounds, as the ViT calls them: the linear norm
    (eps_outside), K2 with the bare cotangent (no mult, no mask)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    kw = dict(eps=LINEAR_NORM_EPS, eps_outside=True)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for label, m, k, n in shapes:
            x, wt, _, _, ct = operands(m, k, n, dtype, gen)
            results = [
                ("bcos_matmul_fwd", " eps_outside", k3.bcos_matmul_fwd(x, wt, **kw),
                 k3.bcos_matmul_fwd_plain(ref(x), ref(wt), **kw)),
                ("bcos_conv1x1_bwd_explain", " eps_outside",
                 k12.conv1x1_bwd_explain(x, wt, ct, None, None, relu=False, **kw),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), None, None,
                                               relu=False, **kw)),
            ]
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, label, dtype, got, want)
            del x, wt, ct, results


def vit_parity(net, x2, tag):
    """fp32, 2 images: the logits and W of the fast pass (explain/fast_vit.py)
    and of the module path (autograd) on the GPU against the same calls on
    the CPU, and the two paths against each other on the GPU: W within ten
    times the CPU's own spread under 1e-7 relative input noise, the
    pre-logits within 1e-4, the argmax identical."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lg, sg, wg = fast_vit.fast_dynamic_linear_weights(net, x2)
    lm, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x2)
    cpu = copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    lc, sc, wc = fast_vit.fast_dynamic_linear_weights(cpu, x2.cpu(), device="cpu")
    lmc, smc, wmc = dynamic_linear_weights(lambda t: cpu(t, explain=True), x2.cpu(), device="cpu")
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 25))
    ln, _, wn = fast_vit.fast_dynamic_linear_weights(cpu, x2.cpu() * (1 + 1e-7 * noise),
                                                     device="cpu")
    cpu_s = time.perf_counter() - t0
    bias = vit_logit_bias(net)
    spread = rel(wn, wc)

    def pre_rel(a, b):
        a, b = a.double().cpu() - bias, b.double().cpu() - bias
        return float((a - b).abs().max() / b.abs().max())

    checks = {
        "W fast pass gpu vs cpu": (rel(wg, wc), 10 * spread),
        "W module path gpu vs cpu": (rel(wm, wmc), 10 * spread),
        "W module path vs fast pass (gpu)": (rel(wm, wg), 10 * spread),
        "pre-logit fast pass gpu vs cpu (max rel)": (pre_rel(lg, lc), 1e-4),
        "pre-logit module path gpu vs cpu (max rel)": (pre_rel(lm, lmc), 1e-4),
        "pre-logit module path vs fast pass (gpu, max rel)": (pre_rel(lm, lg), 1e-4),
    }
    say(f"vit {tag} parity: pre-logit RMS {float((lc.double() - bias).pow(2).mean().sqrt()):.4g}"
        f" (the CPU's pre-logits move {pre_rel(ln, lc):.3e} under 1e-7 relative input noise); W "
        f"on the cpu under that noise: {spread:.3e}; the three CPU passes took {cpu_s:.1f} s")
    for key, (val, bound) in checks.items():
        say(f"vit {tag} parity {key}: {val:.3e} (bound {bound:.3e})")
    same_sel = bool((sg.cpu() == sc).all() and (sm == sg).all() and (smc == sc).all())
    say(f"vit {tag} parity argmax identical: {same_sel}")
    if not same_sel or any(not val <= bound for val, bound in checks.values()):
        raise AssertionError(f"ViT {tag} parity failed")
    if not all(torch.isfinite(t).all() for t in (lg, wg)) or wg.shape != x2.shape:
        raise AssertionError(f"ViT {tag} outputs are not finite or mis-shaped")


def vit_throughput(net, x, tag="vit"):
    """Forward-only, fast-pass (where ``fast_vit`` supports the net) and
    module-path fwd+explain images/s at batch 128, bf16, each with its launch
    counts, host issue time, peak memory, card busy time and top kernels."""
    calls = [("forward-only", vit_forward(net, x), False),
             ("fwd+explain (fast pass)",
              lambda: fast_vit.fast_dynamic_linear_weights(net, x), True),
             ("fwd+explain (module path)",
              lambda: dynamic_linear_weights(lambda t: net(t, explain=True), x), True)]
    if not fast_vit.supports(net):
        del calls[1]
    return vit_rates(net, calls, tag)


def vit_forward(net, x):
    def forward():
        with torch.no_grad():
            return net(x)
    return forward


def vit_rates(net, calls, tag):
    """{what: rates} of each (what, call, explain) of ``calls`` on ``net``
    at batch 128: its launch counts checked, its outputs finite, its
    images/s over one window, host issue time, peak memory, card busy time
    and top kernels."""
    out = {}
    for what, fn, explain_ in calls:
        fn()
        result, counts = counted(fn)
        check_counts(f"{tag} {what}", counts, vit_counts(net, explain_))
        outs = result if isinstance(result, tuple) else (result,)
        if not all(torch.isfinite(v).all() for v in outs if v.is_floating_point()):
            raise AssertionError(f"{tag} {what}: outputs are not finite")
        del result, outs
        ms, n_calls, host, peak_gb = windowed(fn)
        busy, top = device_profile(fn, 3)
        say(f"{tag} throughput {what}: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per batch of "
            f"{BATCH}, one window of {n_calls} calls; the host issues one call in {host:.2f} "
            f"ms; peak memory of one call {peak_gb:.2f} GB; launches {counts}) [{CARD}]")
        say(f"{tag} {what}: card busy {busy or 0:.2f} ms per call (torch.profiler); top "
            "kernels: " + "; ".join(f"{name[:60]} {t:.2f} ms" for name, t in top))
        out[what] = {"img_s": BATCH / ms * 1e3, "ms": ms, "host_ms": host, "peak_gb": peak_gb,
                     "busy_ms": busy}
    return out


def vit_serving(net, x, tag="vit"):
    """The forward and the fwd+explain programs exported, saved to bytes and
    loaded back: at batch 128, bf16, equal to the eager calls (1e-6
    relative, the same launch counts); the loaded fwd+explain's images/s and
    the seconds of each export and of the two loads."""
    seconds = {}
    t0 = time.perf_counter()
    blob_fwd = serving.export_forward(net, input_size=SIZE, dtype=torch.bfloat16)
    seconds["export_forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = serving.export_explain(net, input_size=SIZE, dtype=torch.bfloat16)
    seconds["export_explain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd, program = serving.load_serialized(blob_fwd), serving.load_serialized(blob)
    seconds["load both"] = time.perf_counter() - t0
    say(f"{tag} serving: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
        + f" ({len(blob_fwd) / 1e6:.1f} MB and {len(blob) / 1e6:.1f} MB)")
    (logits, sel, w), counts = counted(lambda: program.call(x))
    check_counts(f"{tag} loaded fwd+explain", counts, vit_counts(net, True))
    logits_f, counts_f = counted(lambda: fwd.call(x))
    check_counts(f"{tag} loaded forward", counts_f, vit_counts(net, False))
    le, se, we = fast_vit.fast_dynamic_linear_weights(net, x)
    with torch.no_grad():
        lf = net(x)
    bias = vit_logit_bias(net)
    checks = {
        "W loaded vs eager (rel)": (rel(w.float(), we.float()), 1e-6),
        "pre-logit loaded vs eager fwd+explain (rel)": (rel(logits.double() - bias,
                                                            le.double() - bias), 1e-6),
        "pre-logit loaded vs eager forward (rel)": (rel(logits_f.double() - bias,
                                                        lf.double() - bias), 1e-6),
    }
    for key, (val, bound) in checks.items():
        say(f"{tag} serving {key}: {val:.3e} (bound {bound:.0e})")
    if (not torch.equal(sel, se) or not torch.equal(logits_f.argmax(1), lf.argmax(1))
            or any(not val <= bound for val, bound in checks.values())):
        raise AssertionError(f"the loaded {tag} programs disagree with the eager calls")
    del logits, sel, w, le, se, we
    ms, calls, host, _ = windowed(lambda: program.call(x))
    say(f"{tag} serving loaded fwd+explain: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms; one "
        f"window of {calls} calls; host {host:.2f} ms) [{CARD}]")
    return {"export_seconds": seconds, "loaded_img_s": BATCH / ms * 1e3}


def vit_evaluate(net, exp_root):
    """``evaluate --base_network vit_bcosification --experiment_name VIT_NAME
    --reload fresh`` over the synthetic tree's val split, with its launches
    (K3 at every bias-free B-cos linear per eval batch of 64)."""
    experiment = VIT_EXPERIMENTS["default"]
    batches = -(-ENTRY_VAL // Experiment(*experiment).config["data"]["batch_size"])
    reset_launch_counts()
    t0 = time.perf_counter()
    top1, top5, (c1, c5, n) = evaluate_cli.main(
        ["--base_network", experiment[1], "--experiment_name", experiment[2], "--reload",
         "fresh", "--base_directory", str(exp_root)])
    torch.cuda.synchronize()
    counts = launch_counts()
    eval_s = time.perf_counter() - t0
    say(f"vit evaluate --reload fresh: top-1 {top1:.6f} ({c1}/{n}), top-5 {top5:.6f} ({c5}/{n}) "
        f"in {eval_s:.1f} s ({batches} batches); launches {counts}")
    check_counts("vit evaluate --reload fresh", counts,
                 scaled_counts(vit_counts(net, False), batches))
    if n != ENTRY_VAL:
        raise AssertionError(f"vit evaluate saw {n} images")
    return eval_s


def phase_vit(x2, stream_rate, worst, exp_root):
    """Phase 13: ViT-B/16 of the vit_bcosification recipe (random init from
    SEED), the default config and its useBias_noGelu_gapReorder variant.
    Returns the ViT keys of K2's and K3's rows of the kernels line."""
    check_vit_kernels(worst)
    nets = {}
    for tag, experiment in VIT_EXPERIMENTS.items():
        t0 = time.perf_counter()
        net = Experiment(*experiment).get_model()
        for explain_ in (False, True):
            n = vit_counts(net, explain_)["bcos_matmul_fwd"]
            if n != VIT_LINEARS[tag]:
                raise AssertionError(f"vit {tag}: {n} bias-free B-cos linears, expected "
                                     f"{VIT_LINEARS[tag]}")
        say(f"vit {tag}: built {experiment[2]} in {time.perf_counter() - t0:.1f} s; "
            f"{VIT_LINEARS[tag]} bias-free B-cos linears")
        vit_parity(net, x2, tag)
        x = _batch128(x2, SEED + 26)
        for explain_ in (False, True):  # the counts of this variant on the card
            fn = ((lambda: fast_vit.fast_dynamic_linear_weights(net, x)) if explain_
                  else (lambda: net(x, explain=False)))
            with torch.no_grad():
                _, counts = counted(fn)
            check_counts(f"vit {tag} {'fwd+explain' if explain_ else 'forward'}", counts,
                         vit_counts(net, explain_))
            say(f"vit {tag} launches per {'fwd+explain' if explain_ else 'forward'}: {counts}")
        del x
        nets[tag] = net
    net = nets["default"]
    del nets
    x = _batch128(x2, SEED + 27)
    rates = vit_throughput(net, x)
    model_config = Experiment(*VIT_EXPERIMENTS["default"]).model_config
    shallow = build_bcosified_vit(model_config, seed=SEED, arch_cfg={
        **VIT_CONFIGS[model_config["name"]], "depth": VIT_EXPORT_DEPTH})
    served = vit_serving(shallow, x, tag=f"vit depth {VIT_EXPORT_DEPTH}")
    del shallow
    del x
    eval_s = vit_evaluate(net, exp_root)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 28)
    rows = time_shapes(collections.Counter(vit_launches(net, BATCH, SIZE, True)), stream_rate,
                       gen, tag="vit ")
    say(f"vit summary: forward-only {rates['forward-only']['img_s']:.1f} img/s, fwd+explain "
        f"{rates['fwd+explain (fast pass)']['img_s']:.1f} (fast pass) / "
        f"{rates['fwd+explain (module path)']['img_s']:.1f} (module path); loaded fwd+explain "
        f"{served['loaded_img_s']:.1f} (depth {VIT_EXPORT_DEPTH}); export_forward "
        f"{served['export_seconds']['export_forward']:.1f} s, export_explain "
        f"{served['export_seconds']['export_explain']:.1f} s; evaluate "
        f"{eval_s:.1f} s [{CARD}]")
    keys = {}
    counts = vit_counts(net, True)
    for name, r in rows.items():
        what = "explanation" if name == "bcos_conv1x1_bwd_explain" else "forward"
        say(f"vit {name} per ViT-B/16 {what} ({counts[name]} launches): {r['ms']:.4f} ms; "
            f"bound {1e3 * r['bound_s']:.4f} ms at the data-sheet rate, "
            f"{1e3 * r['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} GB/s; "
            f"plain {r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms [{CARD}]")
        keys[name] = {"vit_launches": counts[name], "vit_ms": r["ms"],
                      "vit_bound_ms": 1e3 * r["bound_s"], "vit_plain_ms": r["plain_ms"],
                      "vit_library_ms": r["library_ms"]}
    return keys


# --------------------------------------------------------------------------
# 14: ViT training, and the from-scratch ViTs of vit_final
# --------------------------------------------------------------------------
VIT_FINAL_EXPERIMENTS = {"vitc": ("ImageNet", "vit_final", "bcos_vitc_b_patch1_14"),
                         "bcos vit": ("ImageNet", "vit_final", "bcos_simple_vit_b_patch16_224")}
# the entry points' configs: a B-cos ViT-C and a standard (3-channel) one
VIT_FINAL_CLI = ("bcos_vitc_ti_patch1_14", "vitc_ti_patch1_14")
VIT_TRAIN_BATCH = 64  # vit_bcosification's batch for the big ViT-B
VIT_TRAIN_WINDOW = 10
# K3 launches per forward and per train step (3 per encoder, the patch
# embedding, the head): ViT-B/16, 12 encoders; ViT-C B, 11
VIT_TRAIN_K3, VITC_K3 = 38, 35
VIT_STEP_LOSS_BOUND = 1e-5
VIT_EXPORT_DEPTH = 1  # the ViT export round trips run at a cut depth (export time)


def recipe_step(net, config, amp, device=None):
    """(a train state around a copy of ``net`` on ``device``, default its
    own, the config's train step: its criterion, optimizer, schedule, AGC
    or clip)."""
    opt = config["optimizer"]
    state = steps_lib.create_train_state(net, opt.create, device=device)
    step = steps_lib.make_train_step(
        config["criterion"], config["lr_scheduler"].create(opt.lr, steps_per_epoch=1000),
        use_agc=config.get("use_agc", False),
        gradient_clip_val=(config.get("trainer") or {}).get("gradient_clip_val"), amp=amp)
    return state, step


def _one_step(net, config, batch, device):
    """(loss, {name: Adam's first moment}, {name: updated parameter}), both
    in f64 on the CPU, after one fp32 step of the config's recipe on a copy
    of ``net`` on ``device``."""
    state, step = recipe_step(net, config, amp=False, device=device)
    state, metrics = step(state, {k: v.to(device) for k, v in batch.items()})
    named = list(state.model.named_parameters())
    return (float(metrics["loss"]),
            {n: state.optimizer.state[p]["exp_avg"].double().cpu() for n, p in named},
            {n: p.detach().double().cpu() for n, p in named})


def vit_step_parity(net, config, batch):
    """One fp32 step of the config's recipe on the GPU against the same step
    on a CPU copy: {check: (value, bound)} for the loss (1e-5 relative);
    Adam's first moment (0.1 times the clipped gradient), its worst leaf's
    distance over the largest leaf's norm, within ten times the CPU's own
    spread under 1e-7 relative input noise; and the updated parameters. Adam's
    first update is the step-0 lr times the sign of the gradient: where the
    first moment exceeds 1e-3 of its leaf's largest, the GPU's parameter
    change lies within 2e-3 lr of the CPU's, beyond one fp32 spacing of the
    parameter (the worst element's excess over that spacing, in units of lr)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss_g, mu_g, p_g = _one_step(net, config, batch, "cuda")
    cpu = copy.deepcopy(net).to("cpu")
    loss_c, mu_c, p_c = _one_step(cpu, config, batch, "cpu")
    noise = torch.randn(batch["image"].shape, generator=torch.Generator().manual_seed(SEED + 30))
    noisy = {"image": batch["image"].cpu() * (1 + 1e-7 * noise), "label": batch["label"]}
    _, mu_n, _ = _one_step(cpu, config, noisy, "cpu")
    top = max(float(m.norm()) for m in mu_c.values())

    def worst(mu):
        return max(float((mu[n] - m).norm()) for n, m in mu_c.items()) / top

    opt = config["optimizer"]
    lr = config["lr_scheduler"].create(opt.lr, steps_per_epoch=1000)(0)
    step_err = 0.0
    for n, m in mu_c.items():  # both started from net's parameters: compare p_g - p_c
        signal = m.abs() > 1e-3 * m.abs().max()
        p32 = p_c[n].abs().float()
        spacing = (torch.nextafter(p32, torch.full_like(p32, math.inf)) - p32).double()
        excess = ((p_g[n] - p_c[n]).abs() - spacing)[signal]
        if excess.numel():
            step_err = max(step_err, float(excess.max()) / lr)
    return {"loss": (abs(loss_g - loss_c) / abs(loss_c), VIT_STEP_LOSS_BOUND),
            "Adam first moment": (worst(mu_g), 10 * worst(mu_n)),
            "updated parameters": (step_err, 2e-3)}


def vit_train_window(tag, net, config, batch, want_k3):
    """One recipe train step's launches (K3 ``want_k3``, K1 and K2 none),
    then its ms, img/s, host issue ms and peak memory over VIT_TRAIN_WINDOW
    steps in a row after a warm-up step (bf16 amp), the card's busy time and
    top kernels; the losses finite."""
    state, step = recipe_step(net, config, amp=True)
    losses = [step(state, batch)[1]["loss"]]
    (_, metrics), per_step = counted(lambda: step(state, batch))
    losses.append(metrics["loss"])
    check_counts(f"{tag} train step", per_step, {**dict.fromkeys(MODEL_KERNELS, 0),
                                                "bcos_matmul_fwd": want_k3, "stream_add": 0})
    torch.cuda.reset_peak_memory_stats()
    host = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(VIT_TRAIN_WINDOW):
        t0 = time.perf_counter()
        losses.append(step(state, batch)[1]["loss"])
        host.append(1e3 * (time.perf_counter() - t0))
    end.record()
    end.synchronize()
    n = batch["image"].shape[0]
    ms = start.elapsed_time(end) / VIT_TRAIN_WINDOW
    out = {"ms": ms, "img_s": n / ms * 1e3, "host_ms": statistics.median(host),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": per_step}
    busy, top = device_profile(lambda: step(state, batch), 3)
    out["busy_ms"] = busy
    losses = [float(v) for v in losses]
    say(f"{tag} train step: {out['img_s']:.1f} img/s ({ms:.2f} ms per step of {n}, bf16 amp, "
        f"one window of {VIT_TRAIN_WINDOW} steps; the host issues a step in "
        f"{out['host_ms']:.2f} ms (median; {min(host):.2f}-{max(host):.2f}); peak memory "
        f"{out['peak_gb']:.1f} GB; card busy {busy or 0:.2f} ms per step (torch.profiler); "
        f"launches {per_step}) [{CARD}]")
    say(f"{tag} train step top kernels: "
        + "; ".join(f"{name[:60]} {t:.2f} ms" for name, t in top))
    say(f"{tag} train losses: " + ", ".join(f"{v:.6f}" for v in losses))
    if not all(math.isfinite(v) for v in losses) or not all(
            math.isfinite(float(p.detach().float().sum())) for p in state.model.parameters()):
        raise AssertionError(f"{tag}: the losses or parameters are not finite")
    return out


def check_vit_train_kernels(launches, worst):
    """K3 against its plain version at every distinct shape of ``launches``
    (the ViT-B/16 train step's and the ViT-C B forward's), both dtypes,
    phase 3's bounds, with the linear norm (eps_outside)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    kw = dict(eps=LINEAR_NORM_EPS, eps_outside=True)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for name, m, k, n, _, _ in sorted(set(launches)):
            x, wt, *_ = operands(m, k, n, dtype, gen)
            got = k3.bcos_matmul_fwd(x, wt, **kw)
            want = k3.bcos_matmul_fwd_plain(ref(x), ref(wt), **kw)
            torch.cuda.synchronize()
            _check(worst, name, " eps_outside", f"vit M={m} K={k} N={n}", dtype, got, want)
            del x, wt, got, want


def _images(n, seed, channels=6):
    """n AddInverse images (or normalised RGB for 3 channels) of SIZE,
    float32 on the card, made from ``seed``, and labels."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((n, SIZE, SIZE, 3), device="cuda", generator=gen)
    x = torch.cat([x, 1.0 - x], dim=-1) if channels == 6 else (x - 0.45) / 0.225
    return {"image": x, "label": torch.randint(0, 1000, (n,), device="cuda", generator=gen)}


def vitc_parity(net, x2):
    """fp32, 2 images: the logits and W of the module path (autograd) on the
    GPU against the CPU, and of the hand-scheduled pass (explain/fast_vit.py
    with the stem's transpose) against the module path on the GPU: the
    pre-logits within 1e-4, W within ten times the CPU's own spread under
    1e-7 relative input noise, the argmax identical."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lg, sg, wg = dynamic_linear_weights(lambda t: net(t, explain=True), x2)
    lf, sf, wf = fast_vit.fast_dynamic_linear_weights(net, x2)
    cpu = copy.deepcopy(net).to("cpu")
    lc, sc, wc = dynamic_linear_weights(lambda t: cpu(t, explain=True), x2.cpu(), device="cpu")
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 32))
    _, _, wn = dynamic_linear_weights(lambda t: cpu(t, explain=True),
                                      x2.cpu() * (1 + 1e-7 * noise), device="cpu")
    bias = vit_logit_bias(net)
    pre_g, pre_c = lg.double().cpu() - bias, lc.double() - bias
    checks = {"pre-logit gpu vs cpu (max rel)": (
                  float((pre_g - pre_c).abs().max() / pre_c.abs().max()), 1e-4),
              "logit gpu vs cpu (max rel)": (
                  float((lg.double().cpu() - lc).abs().max() / lc.abs().max()), 1e-4),
              "W gpu vs cpu": (rel(wg, wc), 10 * rel(wn, wc)),
              "W fast pass vs module path (gpu)": (rel(wf, wg), 10 * rel(wn, wc)),
              "pre-logit fast pass vs module path (max rel)": (
                  float((lf.double() - lg.double()).abs().max()
                        / (lg.double() - bias).abs().max()), 1e-4)}
    for key, (val, bound) in checks.items():
        say(f"vitc parity {key}: {val:.3e} (bound {bound:.3e})")
    same = bool((sg.cpu() == sc).all() and (sf == sg).all())
    say(f"vitc parity argmax identical: {same}; pre-logit RMS "
        f"{float(pre_c.pow(2).mean().sqrt()):.4g}")
    if not same or any(not val <= bound for val, bound in checks.values()):
        raise AssertionError("ViT-C B parity failed")
    if not torch.isfinite(wg).all() or wg.shape != x2.shape:
        raise AssertionError("ViT-C B outputs are not finite or mis-shaped")


def vitc_export(model_config, x2):
    """Fault C5's check: the ViT-C B at VIT_EXPORT_DEPTH, its fp32
    export_explain (the hand-scheduled pass with the stem's transpose)
    loaded from bytes: on 2 images its W against the module path's on the
    GPU within ten times the CPU's own spread under 1e-7 relative input
    noise, the argmax identical, its launches those of the pass. The bf16
    round trip of fast_vit's programs is the B-cos ViT-B's (phase 14 (c))."""
    vit_final_model = importlib.import_module(
        "bcosification_tpu_torch.experiments.ImageNet.vit_final.model")
    shallow = vit_final_model.get_model(model_config, depth=VIT_EXPORT_DEPTH)
    t0 = time.perf_counter()
    program = serving.load_serialized(serving.export_explain(shallow, input_size=SIZE))
    export_s = time.perf_counter() - t0
    (logits, sel, w), counts = counted(lambda: program.call(x2))
    check_counts("vitc loaded fp32 fwd+explain", counts, vit_counts(shallow, True))
    lm, sm, wm = dynamic_linear_weights(lambda t: shallow(t, explain=True), x2)
    cpu = copy.deepcopy(shallow).to("cpu")
    _, _, wc = dynamic_linear_weights(lambda t: cpu(t, explain=True), x2.cpu(), device="cpu")
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 39))
    _, _, wn = dynamic_linear_weights(lambda t: cpu(t, explain=True),
                                      x2.cpu() * (1 + 1e-7 * noise), device="cpu")
    err, bound = rel(w, wm), 10 * rel(wn, wc)
    say(f"vitc depth {VIT_EXPORT_DEPTH} export_explain (fp32, {export_s:.1f} s): loaded W vs the "
        f"module path (gpu) {err:.3e} (bound {bound:.3e}); argmax identical "
        f"{bool(torch.equal(sel, sm))}; launches {counts}")
    if not err <= bound or not torch.equal(sel, sm) or not torch.isfinite(w).all():
        raise AssertionError("the exported ViT-C explanation disagrees with the module path")
    return {"export_explain_fp32_s": export_s}


def vit_final_cli(exp_root):
    """``train --base_network vit_final --fast_dev_run --amp`` of each of
    VIT_FINAL_CLI over phase 9's JPEG tree, then ``evaluate --reload last``
    equal to the logged accuracies, with the launches (K3 at every
    bias-free B-cos linear of the B-cos ViT-C, none in the standard one)."""
    out = {}
    for name in VIT_FINAL_CLI:
        experiment = ("ImageNet", "vit_final", name)
        exp = Experiment(*experiment)
        per_forward = vit_counts(exp.get_model(), False)
        val_batches = -(-ENTRY_VAL // exp.config["data"]["batch_size"])
        base = ["--base_network", "vit_final", "--experiment_name", name, "--base_directory",
                str(exp_root)]
        t0 = time.perf_counter()
        _, counts = counted(lambda: train_cli.main(["--dataset", "ImageNet", *base, "--amp",
                                                   "--fast_dev_run"]))
        train_s = time.perf_counter() - t0
        check_counts(f"{name} train --fast_dev_run", counts,
                     scaled_counts(per_forward, 1 + val_batches))
        logged = exp.load_metrics()
        want = (logged["val_acc1"][-1][1], logged["val_acc5"][-1][1])
        t0 = time.perf_counter()
        (top1, top5, (_, _, n)), counts_e = counted(
            lambda: evaluate_cli.main([*base, "--reload", "last"]))
        eval_s = time.perf_counter() - t0
        check_counts(f"{name} evaluate", counts_e, scaled_counts(per_forward, val_batches))
        say(f"vit_final {name}: train --fast_dev_run {train_s:.1f} s (train loss "
            f"{logged['train_loss'][-1][1]:.6f}, launches {counts}); evaluate --reload last "
            f"{eval_s:.1f} s: top-1 {top1:.6f}, top-5 {top5:.6f} (logged {want[0]:.6f} / "
            f"{want[1]:.6f}); launches {counts_e}")
        if (n != ENTRY_VAL or (top1, top5) != want or exp.available_checkpoints() != [0]
                or not math.isfinite(logged["train_loss"][-1][1])):
            raise AssertionError(f"vit_final {name}: the entry points disagree")
        out[name] = {"train_s": train_s, "eval_s": eval_s}
    return out


def phase_vit_train(x2, stream_rate, worst, exp_root):
    """Phase 14: ViT-B/16's recipe train step (vit_bcosification), the
    ViT-C B of vit_final (parity, forward, explanation, train step), the
    B-cos ViT-B of vit_final (fast pass against the module path, the export
    round trip at a cut depth), the vit_final entry points, and K3 at every
    shape of the ViT-B train step and the ViT-C B forward. Returns K3's keys
    of the kernels line."""
    exp_a = Experiment(*VIT_EXPERIMENTS["default"])
    exp_c = Experiment(*VIT_FINAL_EXPERIMENTS["vitc"])
    vit_b, vitc = exp_a.get_model(), exp_c.get_model()
    launches_a = vit_launches(vit_b, VIT_TRAIN_BATCH, SIZE, False)
    launches_c = vit_launches(vitc, BATCH, SIZE, False)
    if (len(launches_a), len(launches_c)) != (VIT_TRAIN_K3, VITC_K3):
        raise AssertionError(f"K3 launches listed: {len(launches_a)} and {len(launches_c)}")
    check_vit_train_kernels(launches_a + launches_c, worst)

    # (a) ViT-B/16, the vit_bcosification recipe
    batch = _images(VIT_TRAIN_BATCH, SEED + 33)
    train_a = vit_train_window("vit-b/16", vit_b, exp_a.config, batch, VIT_TRAIN_K3)
    del batch
    t0 = time.perf_counter()
    checks = vit_step_parity(vit_b, exp_a.config, {"image": x2, "label": torch.tensor(
        [1, 3], device="cuda")})
    for key, (val, bound) in checks.items():
        say(f"vit-b/16 train parity fp32 gpu vs cpu, {key}: {val:.3e} (bound {bound:.3e})")
    say(f"vit-b/16 train parity took {time.perf_counter() - t0:.1f} s")
    if any(not val <= bound for val, bound in checks.values()):
        raise AssertionError("the ViT-B/16 train step on the GPU disagrees with the CPU")
    del vit_b

    # (b) ViT-C B of vit_final
    vitc_parity(vitc, x2)
    vitc_served = vitc_export(exp_c.model_config, x2)
    x = _batch128(x2, SEED + 34)
    rates_c = vit_throughput(vitc, x, tag="vitc")
    del x
    batch = _images(BATCH, SEED + 35)
    train_c = vit_train_window("vitc", vitc, exp_c.config, batch, VITC_K3)
    del batch

    # (c) the B-cos ViT-B of vit_final: BcosLinear, the logit layer inside
    experiment = VIT_FINAL_EXPERIMENTS["bcos vit"]
    model_config = Experiment(*experiment).model_config
    vit_final_model = importlib.import_module(
        "bcosification_tpu_torch.experiments.ImageNet.vit_final.model")
    bcos_vit = vit_final_model.get_model(model_config)
    vit_parity(bcos_vit, x2, "vit_final bcos_simple_vit_b")
    del bcos_vit
    shallow = vit_final_model.get_model(model_config, depth=VIT_EXPORT_DEPTH)
    served = vit_serving(shallow, _batch128(x2, SEED + 36),
                         tag=f"vit_final bcos_simple_vit_b depth {VIT_EXPORT_DEPTH}")
    del shallow

    # (d) the entry points
    cli = vit_final_cli(exp_root)

    # (e) K3 at every shape of (a) and (b)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 37)
    keys = {}
    for key, what, launches in (("vit_train", "ViT-B/16 train step at batch 64", launches_a),
                                ("vitc", "ViT-C B forward at batch 128", launches_c)):
        r = time_shapes(collections.Counter(launches), stream_rate, gen,
                        tag=key + " ")["bcos_matmul_fwd"]
        say(f"bcos_matmul_fwd per {what} ({len(launches)} launches): {r['ms']:.4f} ms; bound "
            f"{1e3 * r['bound_s']:.4f} ms at the data-sheet rate, "
            f"{1e3 * r['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} GB/s; "
            f"plain {r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms [{CARD}]")
        keys.update({f"{key}_launches": len(launches), f"{key}_ms": r["ms"],
                     f"{key}_bound_ms": 1e3 * r["bound_s"], f"{key}_plain_ms": r["plain_ms"],
                     f"{key}_library_ms": r["library_ms"]})
    say(f"vit train summary: ViT-B/16 train step {train_a['img_s']:.1f} img/s (batch "
        f"{VIT_TRAIN_BATCH}, host {train_a['host_ms']:.2f} ms, busy "
        f"{train_a['busy_ms'] or 0:.2f} ms of {train_a['ms']:.2f}); ViT-C B forward-only "
        f"{rates_c['forward-only']['img_s']:.1f} img/s, fwd+explain (module path) "
        f"{rates_c['fwd+explain (module path)']['img_s']:.1f}, train step "
        f"{train_c['img_s']:.1f} (batch {BATCH}); export at depth {VIT_EXPORT_DEPTH}: "
        f"export_forward {served['export_seconds']['export_forward']:.1f} s, export_explain "
        f"{served['export_seconds']['export_explain']:.1f} s; the ViT-C B at depth "
        f"{VIT_EXPORT_DEPTH}: export_explain (fp32) {vitc_served['export_explain_fp32_s']:.1f}"
        f" s; entry points "
        + ", ".join(f"{k} {v['train_s']:.1f} + {v['eval_s']:.1f} s" for k, v in cli.items())
        + f" [{CARD}]")
    return keys


# --------------------------------------------------------------------------
# 15: the analyses
# --------------------------------------------------------------------------
LOC_CONFIG = "50_3x3_noconfthresh"
LOC_IMAGES = 4096  # seeded synthetic images, labelled by the model's own argmax
LOC_MIN_GRIDS = 8
LOC_BATCH = 64  # the analyser's forward batch (its default)
LOC_GRID = 3 * SIZE  # a 3x3 multi-image of 224^2 cells: 672^2
# per grid: the explanation-mode module path (K1 forward and K2 backward at
# the 36 fused 1x1 convs, K3 and K2 at the classifier), fault C1's route of
# the gradient explainers (no K1, no K2, K3 at the 34 stride-1 1x1 convs),
# and DeepLIFT in explanation mode (no conv on K1: the 33 stride-1 1x1 convs
# and the classifier on K3 forward and K2 backward, the stride-2
# downsamples on cuDNN)
LOC_DEEPLIFT_EXPLAIN_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 34,
                               "bcos_matmul_fwd": 34, "stream_add": 0}
LOC_EXPLAINERS = [  # (label, explainer, its options, launches per grid)
    ("Ours", "Ours", {}, EXPLAIN_COUNTS),
    ("OursRelative", "OursRelative", {}, EXPLAIN_COUNTS),
    ("IxG", "IxG", {}, EVAL_GRADIENT_COUNTS),
    ("Grad", "Grad", {}, EVAL_GRADIENT_COUNTS),
    ("IntGrad", "IntGrad", {}, scaled_counts(EVAL_GRADIENT_COUNTS, 20)),
    ("GB", "GB", {}, EVAL_GRADIENT_COUNTS),
    ("DeepLIFT", "DeepLIFT", {}, EVAL_GRADIENT_COUNTS),
    ("DeepLIFT explanation mode", "DeepLIFT", {"explanation_mode": True},
     LOC_DEEPLIFT_EXPLAIN_COUNTS),
    # the black-box methods: batches of 64 perturbed copies, forward only
    ("Occlusion", "Occlusion", {}, scaled_counts(  # 83 x 83 windows, and the image
        EVAL_BATCH_COUNTS, 1 + -(-((LOC_GRID - 16) // 8 + 1) ** 2 // 64))),
    ("RISE", "Rise", {}, scaled_counts(EVAL_BATCH_COUNTS, -(-500 // 64))),
    ("LIME", "Lime", {}, scaled_counts(EVAL_BATCH_COUNTS, -(-200 // 64))),
]
LOC_SCORE_BOUND = 1e-3  # the grid's scores, fp32 GPU against CPU
LOC_PARITY_TARGETS = 1  # of the grid's 9: the fp32 CPU pass is ~5 s per target (C7)
VIT_STRIDE_CONFIG, VIT_STRIDE_GRIDS = "50_3x3_noconfthresh-stride=112", 2


class CastInput(torch.nn.Module):
    """``net`` on inputs cast to ``dtype``: the analyses hand f32 images to
    the bf16 nets (the input's gradient comes back in f32)."""

    def __init__(self, net, dtype=torch.bfloat16):
        super().__init__()
        self.net, self.dtype = net, dtype

    def forward(self, x, *, train=False, explain=False):
        return self.net(x.to(self.dtype), train=train, explain=explain)


class LabelledImages:
    """The analyser's dataset: RGB uint8 images [n, S, S, 3] on the host as
    AddInverse f32 [S, S, 6], each labelled by ``labels``."""

    def __init__(self, rgb, labels):
        self.rgb, self.labels = rgb, labels

    def __len__(self):
        return len(self.rgb)

    def __getitem__(self, i):
        a = self.rgb[i].numpy().astype(np.float32) / np.float32(255)
        return np.concatenate([a, 1.0 - a], axis=-1), int(self.labels[i])


def analysis_images(n, seed):
    """n RGB images [n, SIZE, SIZE, 3] uint8 on the host, made on the card from
    ``seed``, a quarter of each kind: random colour blocks of 2 to 56 px,
    colour gradients, stripes of random frequency and angle, noise of random
    contrast around a random colour."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.rand(shape, device="cuda", generator=gen)

    yy, xx = torch.meshgrid(torch.arange(SIZE, device="cuda") / (SIZE - 1),
                            torch.arange(SIZE, device="cuda") / (SIZE - 1), indexing="ij")
    yy, xx = yy[..., None], xx[..., None]
    out = torch.empty((n, SIZE, SIZE, 3), dtype=torch.uint8, device="cuda")
    cells = (2, 4, 7, 14, 28, 56)
    kinds = r(n, 8)
    for i in range(n):
        p = kinds[i]
        if i % 4 == 0:
            s = cells[int(p[0] * len(cells))]
            a = r(s, s, 3).repeat_interleave(SIZE // s, 0).repeat_interleave(SIZE // s, 1)
        elif i % 4 == 1:
            c = r(3, 3)
            a = c[0] + yy * (c[1] - c[0]) * p[1] + xx * (c[2] - c[0]) * p[2]
        elif i % 4 == 2:
            f, th, c = 2 + 38 * p[1], math.pi * p[2], r(2, 3)
            t = 0.5 + 0.5 * torch.sin(2 * math.pi * f * (torch.cos(th) * xx + torch.sin(th) * yy))
            a = c[0] + t * (c[1] - c[0])
        else:
            a = 0.5 * r(3) + p[1] * r(SIZE, SIZE, 3)
        out[i] = (a.clamp(0, 1) * 255).round().to(torch.uint8)
    return out.cpu()


def argmax_labels(model, rgb):
    """The argmax of ``model`` on the AddInverse images of ``rgb``, in batches
    of LOC_BATCH as the analyser runs them."""
    labels = []
    with torch.no_grad():
        for i in range(0, len(rgb), LOC_BATCH):
            a = rgb[i:i + LOC_BATCH].cuda().float() / 255
            labels.append(model(torch.cat([a, 1.0 - a], dim=-1), train=False).argmax(-1).cpu())
    return torch.cat(labels).numpy()


def loc_dataset(model, n, seed, tag):
    """LabelledImages of n images from ``seed``, labelled by ``model``'s own
    argmax: a random-init net classifies real labels right only by chance
    (and its logit bias -log(999) keeps sigmoid(logit) far below 0.5, hence
    the _noconfthresh config)."""
    t0 = time.perf_counter()
    rgb = analysis_images(n, seed)
    labels = argmax_labels(model, rgb)
    counts = np.bincount(labels)
    say(f"loc {tag}: drew {n} synthetic images in {time.perf_counter() - t0:.1f} s; the "
        f"model's argmax gives {int((counts > 0).sum())} distinct classes (largest counts "
        f"{sorted(counts[counts > 0].tolist())[::-1][:12]})")
    return LabelledImages(rgb, labels)


def check_loc_kernels(model, worst):
    """Each kernel against its plain version at every distinct shape one
    672^2 grid of 9 copies gives it: K1, K2 and K3 of the explanation-mode
    module path (Ours; ``main_path_launches``) and K3 on fault C1's route
    (the gradient explainers; ``train_k3_launches``), both dtypes, phase 3's
    bounds. Most of these M (254 016, 63 504, 15 876, 3 969) are no multiple
    of 128 rows. Returns the number of distinct shapes."""
    shapes = collections.defaultdict(set)  # (M, K, N, relu) -> kernels launched there
    for name, m, k, n, relu in (main_path_launches(model, 9, LOC_GRID)
                                + train_k3_launches(model, 9, LOC_GRID)):
        shapes[(m, k, n, relu)].add(name)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 45)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for (m, k, n, relu), names in sorted(shapes.items()):
            x, wt, mult, add, ct = operands(m, k, n, dtype, gen)
            results = []
            if "bcos_conv1x1_fwd" in names:
                results.append(("bcos_conv1x1_fwd", "",
                                k12.conv1x1_fwd(x, wt, mult, add, relu=relu),
                                k12.conv1x1_fwd_plain(ref(x), ref(wt), mult, add, relu=relu)))
            if "bcos_conv1x1_bwd_explain" in names:
                a = k12.conv1x1_fwd(x, wt, mult, add, relu=True) if relu else None
                results.append(("bcos_conv1x1_bwd_explain", "",
                                k12.conv1x1_bwd_explain(x, wt, ct, a, mult, relu=relu),
                                k12.conv1x1_bwd_explain_plain(
                                    ref(x), ref(wt), ref(ct), None if a is None else ref(a),
                                    mult, relu=relu)))
            if "bcos_matmul_fwd" in names:
                results += _k3_results(x, wt, ref)
            torch.cuda.synchronize()
            for name, variant, got, want in results:
                _check(worst, name, variant, f"loc M={m} K={k} N={n}", dtype, got, want)
            del x, wt, ct, results
    return len(shapes)


def loc_analyser(model, dataset, config_name, save, **overrides):
    from bcosification_tpu_torch.interpretability.analyses.localisation import (
        LocalisationAnalyser,
    )
    from bcosification_tpu_torch.interpretability.analyses.localisation_configs import configs

    cfg = dict(configs[config_name], batch_size=LOC_BATCH)
    cfg.update(overrides)
    return LocalisationAnalyser(model, dataset, save_folder=save, **cfg)


def loc_grid(analyser, indices):
    """The analyser's first 3x3 grid, on the card, and its targets."""
    from bcosification_tpu_torch.interpretability.analyses.localisation import make_multi_image

    grid, tgts, _ = make_multi_image(9, analyser.dataset, 0, indices)
    return torch.from_numpy(grid).cuda(), tgts


def loc_scores(analyser, atts):
    """The grid's per-target scores, as ``analysis`` computes them."""
    from bcosification_tpu_torch.ops.pooling import avg_pool2d

    s = analyser.config["smooth"]
    a = avg_pool2d(atts.float().sum(-1)[..., None], s, 1, (s - 1) // 2)[..., 0]
    return analyser._score(a.clamp_min(0).cpu().numpy(), 9, SIZE)


def loc_explainers(model, grid, tgts):
    """Every explainer on one grid (bf16 model): its seconds (one call after
    a warm-up call; the black-box methods once), its launches, finite maps
    of the grid's shape."""
    from bcosification_tpu_torch.interpretability.explanation_methods import get_explainer

    out = {}
    for label, name, kw, want in LOC_EXPLAINERS:
        explainer = get_explainer(model, name, **kw)
        if name in ("Ours", "OursRelative", "IxG", "Grad", "GB", "DeepLIFT"):
            explainer.attribute_selection(grid, tgts)
        t0 = time.perf_counter()
        atts, counts = counted(lambda: explainer.attribute_selection(grid, tgts))
        seconds = time.perf_counter() - t0
        say(f"loc explainer {label:26s}: {seconds:8.3f} s per 3x3 grid of 672^2 (9 targets); "
            f"launches {counts} [{CARD}]")
        check_counts(f"loc {label}", counts, want)
        if atts.shape != (9, LOC_GRID, LOC_GRID, 6) or not bool(torch.isfinite(atts).all()):
            raise AssertionError(f"loc {label}: attributions {tuple(atts.shape)}, not finite")
        out[label] = seconds
        del atts
    return out


def loc_parity(net, grid, tgts, analyser):
    """fp32, one grid, its first LOC_PARITY_TARGETS targets: Ours (K1/K2 on
    the GPU, the plain versions on the CPU) and GB on the GPU against a CPU
    copy: W within phase 4's 1e-3 (rounding noise alone moves ResNet-50's
    fp32 W by about 1e-4), those targets' localisation scores within
    LOC_SCORE_BOUND."""
    from bcosification_tpu_torch.interpretability.explanation_methods import get_explainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tgts = tgts[:LOC_PARITY_TARGETS]
    cpu = copy.deepcopy(net).to("cpu")
    for name in ("Ours", "GB"):
        got = get_explainer(net, name).attribute_selection(grid, tgts)
        t0 = time.perf_counter()
        want = get_explainer(cpu, name, device="cpu").attribute_selection(grid.cpu(), tgts)
        cpu_s = time.perf_counter() - t0
        err = rel(got, want)
        score_err = float(np.abs(loc_scores(analyser, got) - loc_scores(analyser, want)).max())
        say(f"loc parity {name} fp32 gpu vs cpu: W {err:.3e} (bound 1e-3), scores max |diff| "
            f"{score_err:.3e} (bound {LOC_SCORE_BOUND:.0e}); the cpu took {cpu_s:.1f} s")
        if not err <= 1e-3 or not score_err <= LOC_SCORE_BOUND:
            raise AssertionError(f"loc parity: {name} on the GPU disagrees with the CPU")
    del cpu


def loc_clis(exp_root):
    """localisation.main on phase 9's trained resnet_50 and the sweep on two
    explainers: each reaches its end and writes confidences.pkl, the metric
    array and config.log (the 128 val images of 10 classes of a barely
    trained random-init net: the metric is empty, as the reference gives
    it)."""
    from bcosification_tpu_torch.interpretability.analyses import localisation
    from bcosification_tpu_torch.interpretability.analyses import localisation_sweep

    root = Path(exp_root) / "localisation_results"
    args = localisation.argument_parser().parse_args(
        ["--experiment_name", ENTRY_EXPERIMENT[2], "--analysis_config", LOC_CONFIG,
         "--smooth", "15", "--explainer_name", "Ours", "--save_root", str(root)])
    t0 = time.perf_counter()
    with k1_dtypes("localisation.main"):
        results = localisation.main(args)
    cli_s = time.perf_counter() - t0
    out = root / ENTRY_EXPERIMENT[2] / LOC_CONFIG / "Ours"
    sweep = localisation_sweep.argument_parser().parse_args(
        ["--experiment_name", ENTRY_EXPERIMENT[2], "--reload", "last", "--explainers", "Ours",
         "IxG", "--analysis_configs", LOC_CONFIG, "--save_root", str(root / "sweep")])
    t0 = time.perf_counter()
    with k1_dtypes("localisation_sweep"):
        localisation_sweep.main(sweep)
    sweep_s = time.perf_counter() - t0
    runs = [out] + [root / "sweep" / ENTRY_EXPERIMENT[2] / LOC_CONFIG / e for e in ("Ours", "IxG")]
    files = ("confidences.pkl", "localisation_metric.np.npy", "config.log")
    missing = [str(run / f) for run in runs for f in files if not (run / f).exists()]
    say(f"loc localisation.main --analysis_config {LOC_CONFIG} --smooth 15 --explainer_name Ours "
        f"on the trained {ENTRY_EXPERIMENT[2]}: {cli_s:.1f} s, metric of "
        f"{len(results['localisation_metric'])} classes; localisation_sweep (Ours, IxG) "
        f"{sweep_s:.1f} s; files written: {not missing}")
    if missing:
        raise AssertionError(f"the localisation commands did not write {missing}")
    return {"cli_s": cli_s, "sweep_s": sweep_s}


@contextlib.contextmanager
def shared_gates(masks, record):
    """While active, the ReLU gates of the fast CLIP pass (each stem and 3x3
    segment's output, each block's conv1 output and its output: what its
    backward reads the gates from) are appended to ``masks`` in the order
    the pass makes them (record=True), or set to those recorded
    (record=False): an entry on in the record and off here becomes 1e-30,
    one off in the record and on here 0. Such entries sit within rounding of
    their gate's edge, so the values barely move, while W jumps by the
    entry's whole contribution: two devices' W compare as one function only
    under the same gates."""
    seg_fwd, block_fwd, i = fast_clip._seg_fwd, fast_clip._block_fwd, iter(range(1 << 30))

    def gate(z):
        if record:
            masks.append(z > 0)
            return z
        m = masks[next(i)].to(z.device)
        return torch.where(m, torch.where(z > 0, z, torch.full_like(z, 1e-30)),
                           torch.zeros_like(z))

    def seg(u, n, bn, relu):
        z = seg_fwd(u, n, bn, relu)
        return gate(z) if relu else z

    def block(blk, a, dtype):
        out, rec = block_fwd(blk, a, dtype)
        rec["c1"] = gate(rec["c1"])
        rec["out"] = out = gate(out)
        return out, rec

    fast_clip._seg_fwd, fast_clip._block_fwd = seg, block
    try:
        yield
    finally:
        fast_clip._seg_fwd, fast_clip._block_fwd = seg_fwd, block_fwd


@contextlib.contextmanager
def float64_fast_clip():
    """While active, the fast CLIP pass runs in float64 on the CPU: K1, K2 and
    K3 (whose wrappers take f32 and bf16 only) and the two helpers that cast
    to f32 become their plain float64 formulas. A reference for W free of
    fp32 rounding."""
    from bcosification_tpu_torch.explain import fast_resnet

    def norm(x, eps, outside):
        ssq = (x * x).sum(-1, keepdim=True)
        return torch.sqrt(ssq) + eps if outside else torch.sqrt(ssq + eps)

    def fwd(x, wt, mult, add, *, relu, eps=k12.CONV_NORM_EPS):
        u = x @ wt.t()
        z = (u.abs() / norm(x, eps, False)) * u * mult.to(u.dtype)
        z = z if add is None else z + add.to(u.dtype)
        return z.clamp_min(0) if relu else z

    def bwd(x, wt, ct, a, mult, *, relu, eps=k12.CONV_NORM_EPS, eps_outside=False):
        g = ct if mult is None else ct * mult.to(ct.dtype)
        g = torch.where(a > 0, g, torch.zeros_like(g)) if relu else g
        u = x @ wt.t()
        return (g * (u.abs() / norm(x, eps, eps_outside))) @ wt

    def bcos_matmul(x, wt, *, eps, eps_outside):
        u = x @ wt.t()
        return u * (u.abs() / norm(x, eps, eps_outside))

    class BN(fast_resnet._BN):
        def __init__(self, bn):
            super().__init__(bn)
            self.mult = self.gamma / self.std if self.gamma is not None else 1.0 / self.std
            self.add = self.beta
            self.sm = torch.sign(self.mult) * torch.sqrt(self.mult.abs())

    def seg_bwd(ct, z, n, bn, relu, identity=None):
        ct = torch.where(z > 0, ct, torch.zeros_like(ct)) if relu else ct
        zz = z if identity is None else z - identity
        zz = zz if bn.beta is None else zz - bn.beta
        return ct * bn.sm * torch.sqrt(zz.abs() / n)

    saved = [(fast_clip, "conv1x1_fwd", fwd), (fast_clip, "conv1x1_bwd_explain", bwd),
             (fast_clip, "_BN", BN), (fast_clip, "_seg_bwd", seg_bwd),
             (k3, "bcos_matmul_fwd", bcos_matmul)]
    old = [getattr(mod, name) for mod, name, _ in saved]
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(saved, old):
            setattr(mod, name, fn)


def gated_text_w(student, image, emb, pool_cosine, seed):
    """W of text localisation on the GPU against the CPU under the GPU's
    ReLU gates (``shared_gates``), and the bound: ten times the CPU's own
    spread under 1e-7 relative input noise, under the same gates; the
    GPU's W against a float64 CPU pass (``float64_fast_clip``) under the
    GPU's gates (held to that bound) and under the CPU's, and the CPU's
    fp32 W against float64 under the CPU's gates (readings). Returns (the
    CPU's W under its own gates, {reading: (value, bound or None)}, the
    number of gates that differ between the two devices)."""
    from bcosification_tpu_torch.interpretability.analyses import text_localisation as tl

    def w(net, x, dev):
        return tl.compute_attributions(net, emb.to(x.device), x, pool_cosine=pool_cosine,
                                       device=dev)["dynamic_linear_weights"]

    masks, own = [], []
    with shared_gates(masks, record=True):
        w_gpu = w(student, image, None)
    cpu, x = copy.deepcopy(student).to("cpu"), image.cpu()
    with shared_gates(own, record=True):
        w_own = w(cpu, x, "cpu")
    flips = sum(int((a.cpu() != b).sum()) for a, b in zip(masks, own))
    with shared_gates(masks, record=False):
        w_cpu = w(cpu, x, "cpu")
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed))
    with shared_gates(masks, record=False):
        w_noisy = w(cpu, x * (1 + 1e-7 * noise), "cpu")
    cpu64, x64 = copy.deepcopy(cpu).double(), x.double()
    with float64_fast_clip(), shared_gates(masks, record=False):
        w64_gpu_gates = w(cpu64, x64, "cpu")
    with float64_fast_clip(), shared_gates(own, record=False):
        w64_cpu_gates = w(cpu64, x64, "cpu")
    bound = 10 * rel(w_noisy, w_cpu)
    return w_own, {
        "W gpu vs cpu under the gpu's gates": (rel(w_gpu, w_cpu), bound),
        "W gpu vs float64 under the gpu's gates": (rel(w_gpu, w64_gpu_gates), bound),
        "W gpu vs float64 under the cpu's gates": (rel(w_gpu, w64_cpu_gates), None),
        "W cpu vs float64 under the cpu's gates": (rel(w_own, w64_cpu_gates), None)}, flips


def loc_text(students, kd_student):
    """text_localisation.main with --random_img_path on a synthetic JPEG, for
    phase 11's CLIP-RN50 students, pooled and attn-unpool, and phase 12's
    KD-trained attn-unpool student (each saved as its experiment's
    checkpoint under a fresh experiment root, from which main loads it): the
    .npz and .png written; its launches (K1 and K2 through fast_clip) and
    seconds; W on the GPU against a CPU copy, fp32: under the same ReLU
    gates (``gated_text_w``) within ten times the CPU's spread under 1e-7
    relative input noise, and, for phase 11's students, also as phase 11
    holds it (each device's own gates: PyTorch's CUDA convs within ten
    times that spread, cuDNN's within 1e-3). A gate within rounding of its
    edge can fall either way on either device and move W by its whole
    contribution: 13 of the KD-trained student's do on this image, 1.131e-3
    in all (PERF.md section 7)."""
    cases = {"pooled": (students["pooled"], False), "unpool": (students["unpool"], True),
             "unpool KD": (kd_student, True)}
    out = {}
    for label, (student, unpool) in cases.items():
        with experiment_root() as root:
            out[label] = loc_text_head(label, unpool, student, root)
    return out


def loc_text_head(label, unpool, student, root):
    from PIL import Image

    from bcosification_tpu_torch.clip.load import load as clip_load
    from bcosification_tpu_torch.data.imagenet import imagenet_templates
    from bcosification_tpu_torch.interpretability.analyses import text_localisation as tl

    experiment = CLIP_EXPERIMENTS["unpool" if unpool else "pooled"]
    Experiment(*experiment)._ckpt_manager().save({"model": student.state_dict()}, 0,
                                                 {"val_loss": 0.0})
    img_path = root / "a_dog.jpg"
    rgb = analysis_images(1, SEED + 41)[0].numpy()
    Image.fromarray(np.ascontiguousarray(rgb)).resize((300, 250)).save(img_path, quality=90)
    save = root / "textloc"
    args = tl.argument_parser().parse_args(
        ["--exp_name", experiment[2], "--text_to_localize", "a dog", "--random_img_path",
         str(img_path), "--save_path", str(save)])
    t0 = time.perf_counter()
    results, counts = counted(lambda: tl.main(args))
    cli_s = time.perf_counter() - t0
    # one embedding (the text tower: no kernel) and one explanation
    check_counts(f"loc text {label} main", counts, clip_counts(unpool, True))
    sub = save / "textloc_expl" / "a_dog" / ("smooth0" + ("_attn_unpool" if unpool else ""))
    written = all((sub / f"Text_a_dog{ext}").exists() for ext in (".npz", ".png"))

    _, text, _, _ = clip_load("RN50")  # the random-init tower main embedded with
    emb = tl.embed_phrase(text, "a dog", imagenet_templates)
    image = torch.from_numpy(tl._load_image(str(img_path))).cuda()

    def call(net=student, x=image, dev=None):
        return tl.compute_attributions(net, emb.to(x.device), x, pool_cosine=args.pool_cosine,
                                       device=dev)

    res = call()
    ms = window_ms(call, 10)
    busy, top = device_profile(call, 3, top=40)
    kernel_ms = {name.replace("(anonymous namespace)::", "").split("(")[0]: ms_
                 for name, ms_ in top
                 if any(key in name for key in ("conv1x1", "bcos_matmul", "tf32::"))}
    torch.backends.cudnn.enabled = False
    try:
        w_native = call()["dynamic_linear_weights"]
    finally:
        torch.backends.cudnn.enabled = True
    wc, gated, flips = gated_text_w(student, image, emb, args.pool_cosine, SEED + 42)
    cpu = copy.deepcopy(student).to("cpu")
    noise = torch.randn(image.shape, generator=torch.Generator().manual_seed(SEED + 42))
    wn = call(cpu, image.cpu() * (1 + 1e-7 * noise), "cpu")["dynamic_linear_weights"]
    spread = rel(wn, wc)
    w = res["dynamic_linear_weights"]
    own = {"W gpu (torch convs) vs cpu, own gates": (rel(w_native, wc), 10 * spread),
           "W gpu (cudnn convs) vs cpu, own gates": (rel(w, wc), 1e-3)}
    checks = {key: val for key, val in gated.items() if val[1] is not None}
    checks["W main vs call"] = (rel(results["a dog"]["dynamic_linear_weights"], w), 1e-6)
    if label != "unpool KD":
        checks.update(own)
    say(f"loc text {label}: text_localisation.main {cli_s:.1f} s (pool_cosine "
        f"{args.pool_cosine}; .npz and .png written: {written}; score "
        f"{results['a dog']['score']:.6f}); launches {counts}; one compute_attributions "
        f"{ms:.2f} ms (fp32, 224^2; the card busy {(busy or 0):.2f} ms), its kernels per call "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in kernel_ms.items())
        + f"; W cpu spread under 1e-7 relative input noise {spread:.3e}; ReLU gates that differ "
        f"between the devices {flips} [{CARD}]")
    for key, (val, bound) in {**own, **gated, **checks}.items():
        held = "" if key in checks else (", not held" if bound else "")
        say(f"loc text {label} {key}: {val:.3e}"
            + (f" (bound {bound:.3e}{held})" if bound else " (a reading)"))
    if not written or any(not val <= bound for val, bound in checks.values()):
        raise AssertionError(f"text localisation of the {label} student failed")
    return {"cli_s": cli_s, "ms": ms}


def fp32_rows(what, per_shape, stream_rate, worst, seed):
    """The fp32 routes at every shape of one call of a path: each kernel
    against its plain version (phase 3's fp32 bound), then timed per call of
    the path (``time_shapes``) beside its bound on the 3xTF32 route's tensor
    cores and at 67 TFLOP/s outside them (``fp32_cores_ms``), its plain version and
    torch.matmul, with the card's busy time for the same calls
    (torch.profiler) and the host's time per launch, (call - card) / calls.
    ``what`` names the path; ``per_shape`` {(kernel, M, K, N, relu[,
    eps_outside]): launches}. Returns {kernel: row} with the row's numbers
    and its launches."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls = collections.defaultdict(list)  # kernel -> its calls of one path call
    for (name, m, k, n, relu, *linear), count in sorted(per_shape.items()):
        x, wt, mult, add, ct = operands(m, k, n, torch.float32, gen)
        kern, plain, _ = kernel_calls(name, x, wt, mult, add, ct, relu, any(linear))
        got, want = kern(), plain()
        torch.cuda.synchronize()
        _check(worst, name, " eps_outside" if any(linear) else "",
               f"{what} M={m} K={k} N={n}", torch.float32, got, want)
        calls[name] += [kern] * count
        del got, want
    rows = time_shapes(per_shape, stream_rate, gen, tag=f"{what} fp32 ", dtype=torch.float32)
    for name, r in sorted(rows.items()):
        r["launches"] = sum(c for key, c in per_shape.items() if key[0] == name)
        busy, _ = device_profile(lambda: [f() for f in calls[name]], 3)
        r["busy_ms"] = busy
        host_us = 1e3 * (r["ms"] - (busy or 0)) / r["launches"]
        say(f"{what} fp32 {name} per {what} ({r['launches']} calls): {r['ms']:.4f} ms (the card "
            f"busy {busy or 0:.4f} ms of it; the host {host_us:.1f} us per call); bound "
            f"{1e3 * r['bound_s']:.4f} ms at the data-sheet rates (3xTF32 at 495 TFLOP/s, 3350 "
            f"GB/s), {fp32_cores_ms(r):.4f} ms at 67 TFLOP/s fp32; plain {r['plain_ms']:.4f} ms, "
            f"torch.matmul {r['library_ms']:.4f} ms [{CARD}]")
    del calls
    return rows


def fp32_keys(prefix, rows):
    """The kernels line's keys of ``fp32_rows``' rows, under ``prefix``."""
    return {name: {f"{prefix}_launches": r["launches"], f"{prefix}_ms": r["ms"],
                   f"{prefix}_bound_ms": 1e3 * r["bound_s"],
                   f"{prefix}_bound_fp32_cores_ms": fp32_cores_ms(r),
                   f"{prefix}_plain_ms": r["plain_ms"], f"{prefix}_library_ms": r["library_ms"],
                   f"{prefix}_busy_ms": r["busy_ms"]}
            for name, r in rows.items()}


def loc_text_kernels(student, stream_rate, worst):
    """K1, K2 and K3 in fp32 at every shape of one text localisation of the
    attn-unpool ``student`` (one 224^2 image: K1 and K2 at the 36 1x1s, K3
    and K2 at the c_proj; ``clip_launches``; ``fp32_rows``). Returns the
    kernels line's keys."""
    per_shape = collections.Counter(clip_launches(student, 1, SIZE, True))
    return fp32_keys("loc_text_fp32",
                     fp32_rows("text localisation", per_shape, stream_rate, worst, SEED + 45))


def resnet_fp32_kernels(model, stream_rate, worst):
    """K1 in fp32 per ResNet-50 eval batch (EVAL_BATCH images of 224^2: the
    36 1x1s of every ``evaluate`` and validation batch, fed float32 images)
    and K1 and K2 in fp32 per Ours grid (9 copies of 672^2 through the
    explanation-mode module path, as the fp32 localisation runs it:
    ``main_path_launches``), each through ``fp32_rows``. Returns the
    kernels line's keys."""
    evals = collections.Counter(
        launch for launch in main_path_launches(model, EVAL_BATCH, SIZE)
        if launch[0] == "bcos_conv1x1_fwd")
    grid = collections.Counter(
        launch for launch in main_path_launches(model, 9, LOC_GRID)
        if launch[0] != "bcos_matmul_fwd")
    keys = fp32_keys("eval_fp32", fp32_rows("eval batch", evals, stream_rate, worst, SEED + 46))
    for name, row in fp32_keys("loc_fp32", fp32_rows("Ours grid", grid, stream_rate, worst,
                                                     SEED + 47)).items():
        keys.setdefault(name, {}).update(row)
    return keys


def distinct_targets(logits):
    """Each cell's target: the class its image ranks highest among those the
    cells before it have not taken (the ViT's own argmax, kept distinct)."""
    taken = []
    for row in logits.float():
        order = row.argsort(descending=True).tolist()
        taken.append(next(c for c in order if c not in taken))
    return taken


def loc_vit_striding(seed):
    """Ours on phase 13's ViT-B/16 (bf16) in the striding mode of
    -stride=112: each 672^2 grid zero-padded by 112 and cut into 7 x 7 = 49
    crops of 224^2, each attributed for the 9 targets and folded back; two
    grids, scored as the analyser scores them, with their seconds. The
    random-init ViT's argmax falls on a handful of classes (4 over 1024
    synthetic images), too few for the analyser's sampler, so each cell's
    target is its image's best class not taken by an earlier cell."""
    from bcosification_tpu_torch.interpretability.analyses.localisation import make_multi_image
    from bcosification_tpu_torch.interpretability.explanation_methods import get_explainer

    vit = CastInput(Experiment(*VIT_EXPERIMENTS["default"]).get_model())
    rgb = analysis_images(9 * VIT_STRIDE_GRIDS, seed)
    dataset = LabelledImages(rgb, np.zeros(len(rgb), np.int64))
    explainer = get_explainer(vit, "Ours")
    with tempfile.TemporaryDirectory() as tmp:
        analyser = loc_analyser(vit, dataset, VIT_STRIDE_CONFIG, tmp)
        metric, seconds = [], 0.0
        for g in range(VIT_STRIDE_GRIDS):
            cells = torch.from_numpy(np.stack([dataset[9 * g + i][0] for i in range(9)]))
            with torch.no_grad():
                dataset.labels[9 * g:9 * g + 9] = distinct_targets(vit(cells.cuda()))
            grid, tgts, _ = make_multi_image(9, dataset, 9 * g)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            atts = analyser._strided_attributions(explainer, grid, tgts, SIZE, 112)
            torch.cuda.synchronize()
            seconds += time.perf_counter() - t0
            metric.append(loc_scores(analyser, atts[..., None]))
    metric = np.concatenate(metric)
    say(f"loc vit-b/16 -stride=112: {VIT_STRIDE_GRIDS} grids of 49 crops of 224^2 (9 targets "
        f"each) in {seconds:.2f} s, {seconds / VIT_STRIDE_GRIDS / 49 * 1e3:.1f} ms per crop; "
        f"mean metric {float(metric.mean()):.4f} [{CARD}]")
    if len(metric) != 9 * VIT_STRIDE_GRIDS or not np.isfinite(metric).all():
        raise AssertionError(f"the ViT striding mode scored {len(metric)} classes")
    return seconds


def phase_analyses(net, students, stream_rate, worst, exp_root):
    """Phase 15: the explanation methods and the grid pointing game on the
    calibrated full-width ResNet-50 of phase 4 (bf16, except the fp32
    parity): the analyser on LOC_IMAGES seeded synthetic images labelled by
    the net's own argmax (_noconfthresh), filling at least LOC_MIN_GRIDS
    3x3 grids of 672^2; every explainer on one grid with its seconds and
    launches; fp32 Ours and GB on one grid, GPU against CPU; the
    localisation and sweep commands on phase 9's trained resnet_50; text
    localisation on phase 11's CLIP-RN50 students and phase 12's KD-trained
    attn-unpool student; the ViT-B/16 striding
    mode; each kernel against its plain version and timed at the grid's
    shapes. Returns the kernels line's keys."""
    n_shapes = check_loc_kernels(net.model, worst)
    say(f"loc: K1, K2 and K3 checked at the {n_shapes} distinct shapes of one 672^2 grid of 9 "
        "copies (Ours and the gradient explainers' route)")
    model = CastInput(net)
    dataset = loc_dataset(model, LOC_IMAGES, SEED + 40, "resnet-50")
    with tempfile.TemporaryDirectory() as tmp:
        analyser = loc_analyser(model, dataset, LOC_CONFIG, tmp)
        t0 = time.perf_counter()
        confidences = analyser.compute_sorted_confs()
        confs_s = time.perf_counter() - t0
        indices = analyser.get_sorted_indices(confidences)
        grids = len(indices) // 9
        classes = len({int(dataset.labels[i]) for i in indices})
        say(f"loc analyser: compute_sorted_confs over {len(dataset)} images in {confs_s:.2f} s; "
            f"the sampler drew {len(indices)} images of {classes} distinct classes: {grids} "
            f"grids (at most {analyser.config['sample_size']}) [{CARD}]")
        if grids < LOC_MIN_GRIDS:
            raise AssertionError(f"the analyser filled {grids} grids, fewer than {LOC_MIN_GRIDS}")
        t0 = time.perf_counter()
        metric = analyser.run()["localisation_metric"]
        run_s = time.perf_counter() - t0
        n_grids = len(metric) // 9
        say(f"loc analyser Ours ({LOC_CONFIG}, smooth 15): mean metric "
            f"{float(metric.mean()):.4f} over {len(metric)} classes of {n_grids} grids in "
            f"{run_s:.1f} s (the confidences read back): {n_grids / run_s:.2f} grids/s [{CARD}]")
        if n_grids < LOC_MIN_GRIDS or not np.isfinite(metric).all():
            raise AssertionError(f"the analyser scored {len(metric)} classes")
        grid, tgts = loc_grid(analyser, indices)
        seconds = loc_explainers(model, grid, tgts)
        loc_parity(net, grid, tgts, analyser)
        del grid
    if k12.tma_operands.padded:
        raise AssertionError(f"{k12.tma_operands.padded} analysis calls padded their operands")
    clis = loc_clis(exp_root)
    kd_student = Experiment(*CLIP_EXPERIMENTS["unpool"]).load_trained_model("best_any",
                                                                           verbose=False)
    text = loc_text(students, kd_student)
    del kd_student
    text_keys = loc_text_kernels(students["unpool"], stream_rate, worst)
    resnet_keys = resnet_fp32_kernels(net.model, stream_rate, worst)
    vit_s = loc_vit_striding(SEED + 43)
    # each kernel at the grid's shapes: Ours's module path (that of one fast
    # fwd+explain at batch 9, 672^2) and K3 on the gradient explainers' route
    gen = torch.Generator(device="cuda").manual_seed(SEED + 44)
    ours = time_shapes(collections.Counter(main_path_launches(net.model, 9, LOC_GRID)),
                       stream_rate, gen, tag="loc ")
    grad_k3 = time_shapes(collections.Counter(train_k3_launches(net.model, 9, LOC_GRID)),
                          stream_rate, gen, tag="loc grad ")["bcos_matmul_fwd"]
    keys = {}
    for name, r in list(ours.items()) + [("bcos_matmul_fwd grad", grad_k3)]:
        kernel, what = name.split()[0], "loc_grad" if name.endswith("grad") else "loc"
        launches = (EVAL_GRADIENT_COUNTS if what == "loc_grad" else EXPLAIN_COUNTS)[kernel]
        say(f"loc {kernel} per {'gradient explainer' if what == 'loc_grad' else 'Ours'} grid "
            f"({launches} launches): {r['ms']:.4f} ms; bound {1e3 * r['bound_s']:.4f} ms at the "
            f"data-sheet rate, {1e3 * r['measured_bound_s']:.4f} ms at the measured "
            f"{stream_rate / 1e9:.1f} GB/s; plain {r['plain_ms']:.4f} ms, torch.matmul "
            f"{r['library_ms']:.4f} ms [{CARD}]")
        keys.setdefault(kernel, {}).update({
            f"{what}_launches": launches, f"{what}_ms": r["ms"],
            f"{what}_bound_ms": 1e3 * r["bound_s"], f"{what}_plain_ms": r["plain_ms"],
            f"{what}_library_ms": r["library_ms"]})
    for kernel, row in list(text_keys.items()) + list(resnet_keys.items()):
        keys.setdefault(kernel, {}).update(row)
    say("K1's activations by dtype per path: " + "; ".join(
        f"{path} {dict(seen)}" for path, seen in K1_DTYPES.items()))
    say(f"loc summary: {n_grids} grids, {n_grids / run_s:.2f} grids/s, compute_sorted_confs "
        f"{confs_s:.2f} s; per grid " + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items())
        + f"; localisation.main {clis['cli_s']:.1f} s, sweep {clis['sweep_s']:.1f} s; text "
        f"localisation pooled {text['pooled']['ms']:.2f} ms, attn-unpool "
        f"{text['unpool']['ms']:.2f} ms, KD-trained attn-unpool {text['unpool KD']['ms']:.2f} ms "
        f"per call; ViT-B/16 -stride=112 two grids {vit_s:.1f} s "
        f"[{CARD}]")
    return keys


# --------------------------------------------------------------------------
# 16: the CLIP benchmark harness
# --------------------------------------------------------------------------
BENCH_BATCH = 64  # the CLI's default --batch_size
BENCH_JPEG = 256  # side of the synthetic JPEGs
BENCH_CLS = 1024  # zero-shot test images over the 1000 ImageNet classes
BENCH_LP_CLASSES, BENCH_LP_TRAIN, BENCH_LP_TEST, BENCH_LP_VAL = 10, 2048, 1024, 0.2
BENCH_RET, BENCH_RET_CAPS = 512, 5  # retrieval images, captions per image
BENCH_SEL, BENCH_SEL_CAPS = 256, 4  # caption-selection instances, captions per instance
BENCH_PARITY_IMAGES = 8
BENCH_LP_WD = 1e-4  # the fixed weight decay of the probe head's GPU-vs-CPU parity
BENCH_LP_MIN_ACC1 = 0.9
# the dataset names pick the builder's reader and collate: flickr30k and
# sugar_crepe keep each image's caption list (image_captions_collate)
BENCH_DATASETS = {"cls": "wds/imagenet1k", "lp": "wds/colours", "ret": "wds/flickr30k",
                  "sel": "wds/sugar_crepe"}
# each task's metric keys and each result file's keys, as the JAX CLI writes them
BENCH_KEYS = {
    "zeroshot_classification": {"acc1", "acc5", "mean_per_class_recall"},
    "linear_probe": {"lp_acc1", "lp_acc5", "lp_mean_per_class_recall", "weight_decay",
                     "epochs", "seed", "fewshot_k", "normalized"},
    "zeroshot_retrieval": {f"{d}_retrieval_recall@5" for d in ("image", "text")},
    "image_caption_selection": {"image_acc", "text_acc", "acc"},
    "captioning": {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr",
                   "SPICE"},
}
BENCH_RESULT_KEYS = {"dataset", "model", "pretrained", "task", "metrics", "language"}


def _smooth_jpeg(rng, base=None, noise=0.0):
    """JPEG bytes of a BENCH_JPEG^2 image: an 8x8 field of random colours (or
    ``base`` plus gaussian ``noise``) upscaled bilinearly."""
    import io

    from PIL import Image

    cells = rng.random((8, 8, 3)) * 255 if base is None else (
        np.asarray(base, np.float64) * 255 + noise * rng.standard_normal((8, 8, 3)))
    img = Image.fromarray(np.clip(cells, 0, 255).astype(np.uint8)).resize(
        (BENCH_JPEG, BENCH_JPEG), Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _write_shard(path, samples):
    """One tar of samples {ext: bytes}, keyed by their position."""
    import io
    import tarfile

    path.parent.mkdir(parents=True, exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i, sample in enumerate(samples):
            for ext, data in sample.items():
                info = tarfile.TarInfo(f"{i:06d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def write_bench_trees(root):
    """The four seeded clip-benchmark wds trees under ``root``
    (<name>/<split>/0.tar + classnames.txt + the templates): zero-shot
    classification (BENCH_CLS test JPEGs, the 1000 ImageNet classes and the
    80 OpenAI templates), the separable linear-probe set (BENCH_LP_CLASSES
    classes, each a distinct colour field plus noise), retrieval
    (BENCH_RET images, BENCH_RET_CAPS captions each) and caption selection
    (BENCH_SEL instances of one image and BENCH_SEL_CAPS captions, the
    right one first). Returns {key: dataset root}."""
    import colorsys
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(SEED + 40)
    roots = {key: Path(root) / name.split("/")[-1] for key, name in BENCH_DATASETS.items()}
    colours = [colorsys.hsv_to_rgb(c / BENCH_LP_CLASSES, 0.8, 0.8)
               for c in range(BENCH_LP_CLASSES)]
    jobs = {"cls": [None] * BENCH_CLS,
            "lp_train": [c % BENCH_LP_CLASSES for c in range(BENCH_LP_TRAIN)],
            "lp_test": [c % BENCH_LP_CLASSES for c in range(BENCH_LP_TEST)],
            "ret": [None] * BENCH_RET, "sel": [None] * BENCH_SEL}
    seeds = {key: rng.integers(0, 2**31, len(v)) for key, v in jobs.items()}

    def encode(args):
        seed, cls = args
        r = np.random.default_rng(seed)
        return _smooth_jpeg(r) if cls is None else _smooth_jpeg(r, colours[cls], noise=25.0)

    with ThreadPoolExecutor(8) as pool:
        jpegs = {key: list(pool.map(encode, zip(seeds[key], v))) for key, v in jobs.items()}
    words = [c.replace("/", " ") for c in imagenet_classes]
    for key in ("cls", "lp"):
        names = imagenet_classes if key == "cls" else [f"colour {c}" for c in
                                                       range(BENCH_LP_CLASSES)]
        (roots[key]).mkdir(parents=True, exist_ok=True)
        (roots[key] / "classnames.txt").write_text("\n".join(names) + "\n")
        (roots[key] / "zeroshot_classification_templates.txt").write_text(
            "\n".join(imagenet_templates) + "\n")
    labels = rng.integers(0, len(imagenet_classes), BENCH_CLS)
    _write_shard(roots["cls"] / "test" / "0.tar", [
        {"jpg": j, "cls": str(int(c)).encode()} for j, c in zip(jpegs["cls"], labels)])
    for split in ("train", "test"):
        _write_shard(roots["lp"] / split / "0.tar", [
            {"jpg": j, "cls": str(c).encode()}
            for j, c in zip(jpegs[f"lp_{split}"], jobs[f"lp_{split}"])])

    def captions(n):
        return [f"a photo of a {words[i]} next to a {words[(i * 7 + 3) % len(words)]}."
                for i in rng.integers(0, len(words), n)]

    _write_shard(roots["ret"] / "test" / "0.tar", [
        {"jpg": j, "txt": "\n".join(captions(BENCH_RET_CAPS)).encode()} for j in jpegs["ret"]])
    _write_shard(roots["sel"] / "test" / "0.tar", [
        {"jpg": j, "txt": "\n".join(captions(BENCH_SEL_CAPS)).encode()} for j in jpegs["sel"]])
    return roots


class BenchRecord:
    """Per CLI run: its seconds, the seconds in load_clip, the images and
    synchronised seconds of the image encodes, the tokenizer's host seconds
    and the text tower's synchronised seconds, the classifier build's
    seconds, the bundle and its transform (while ``bench_instruments``
    lasts)."""

    def __init__(self):
        self.runs = []

    def new(self, tag):
        self.runs.append(types.SimpleNamespace(
            tag=tag, load_s=0.0, images=0, batches=0, encode_s=0.0, tokenize_s=0.0,
            text_s=0.0, classifier_s=0.0, bundle=None, transform=None))
        return self.runs[-1]


def _synced(fn, run, images_attr=None):
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        if images_attr:
            run.encode_s += time.perf_counter() - t0
            run.images += args[0].shape[0]
            run.batches += 1
        else:
            run.text_s += time.perf_counter() - t0
        return out
    return call


@contextlib.contextmanager
def bench_instruments(record):
    """While it lasts, the CLI's ``load_clip`` times itself and wraps the
    bundle it returns (image encode and text tower synchronised, the
    tokenizer on the host), and the zero-shot classifier build is timed,
    into ``record``'s newest run."""
    from bcosification_tpu_torch.clip_benchmark import cli as bench_cli
    from bcosification_tpu_torch.clip_benchmark.metrics import zeroshot_classification as zs

    load_fn, clf_fn = bench_cli.load_clip, zs.zero_shot_classifier

    def load_clip(*args, **kwargs):
        run = record.runs[-1]
        t0 = time.perf_counter()
        bundle, transform, tok = load_fn(*args, **kwargs)
        run.load_s = time.perf_counter() - t0
        bundle.encode_image = _synced(bundle.encode_image, run, images_attr=True)
        if bundle.text_model is not None:
            bundle.text_model = _synced(bundle.text_model, run)
        tokenizer = bundle.tokenizer

        def tokenize_timed(texts):
            t1 = time.perf_counter()
            out = tokenizer(texts)
            run.tokenize_s += time.perf_counter() - t1
            return out

        bundle.tokenizer = tokenize_timed
        run.bundle, run.transform = bundle, transform
        return bundle, transform, tok

    def classifier(*args, **kwargs):
        t0 = time.perf_counter()
        out = clf_fn(*args, **kwargs)
        record.runs[-1].classifier_s = time.perf_counter() - t0
        return out

    bench_cli.load_clip, zs.zero_shot_classifier = load_clip, classifier
    try:
        yield record
    finally:
        bench_cli.load_clip, zs.zero_shot_classifier = load_fn, clf_fn


def bench_run(record, tag, argv, k3_per_batch, device=None):
    """One ``cli eval`` in process: its launches (K3 ``k3_per_batch`` per
    encode, K1, K2 and K4 none), its result JSON (JAX's keys, no NaN),
    images/s (the images over the run's seconds less the load and the
    zero-shot classifier build) and the
    host ms per batch (the run less the load, the classifier build, the
    encodes and the text tower). Returns (the run's record, its result)."""
    from bcosification_tpu_torch.clip_benchmark import cli as bench_cli

    run = record.new(tag)
    out = argv[argv.index("--output") + 1]
    t0 = time.perf_counter()
    _, counts = counted(lambda: bench_cli.main(["eval"] + argv, device=device))
    run.seconds = time.perf_counter() - t0
    result = json.loads(Path(out).read_text())
    task = result["task"]
    check_counts(f"bench {tag}", counts, {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                                          "bcos_matmul_fwd": k3_per_batch * run.batches,
                                          "stream_add": 0})
    bad = [k for k, v in result["metrics"].items()
           if isinstance(v, float) and not math.isfinite(v)]
    if set(result) != BENCH_RESULT_KEYS or set(result["metrics"]) != BENCH_KEYS[task] or bad:
        raise AssertionError(f"bench {tag}: result {result} (keys or non-finite {bad})")
    work = run.seconds - run.load_s - run.classifier_s
    host = work - run.encode_s - (0.0 if run.classifier_s else run.text_s)
    run.img_s = run.images / work if run.images else 0.0
    say(f"bench {tag}: {task} {json.dumps(result['metrics'])}; {run.seconds:.2f} s "
        f"(load_clip {run.load_s:.2f} s); {run.images} images in {run.batches} encodes of "
        f"{BENCH_BATCH}: {run.img_s:.1f} img/s end to end, encode {run.encode_s:.2f} s "
        f"(synchronised), host {1e3 * host / max(run.batches, 1):.1f} ms per batch (decode, "
        f"metric), text tower {run.text_s:.2f} s, tokenizer {run.tokenize_s:.2f} s; launches "
        f"{counts} [{CARD}]")
    return run, result


def bench_parity_logits(bundle, classifier, images):
    """fp32 zero-shot logits of ``images`` (the first BENCH_PARITY_IMAGES of
    the classification set) GPU against the port's CPU path: within ten
    times the CPU's own spread under 1e-7 relative input noise."""
    from bcosification_tpu_torch.training.zeroshot import zeroshot_predict_logits

    x = torch.from_numpy(images)
    w = torch.from_numpy(np.asarray(classifier, np.float32))
    cpu = copy.deepcopy(bundle.image_model).to("cpu")
    with torch.no_grad():
        got = zeroshot_predict_logits(bundle.image_model(x.to(bundle.device)),
                                      w.to(bundle.device)).cpu()
        want = zeroshot_predict_logits(cpu(x), w)
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(SEED + 41))
        spread = rel(zeroshot_predict_logits(cpu(x * (1 + 1e-7 * noise)), w), want)
    err = rel(got, want)
    say(f"bench zero-shot logits of {len(x)} images, fp32 gpu vs cpu: {err:.3e} (bound "
        f"{10 * spread:.3e}, ten cpu spreads under 1e-7 relative input noise); argmax equal: "
        f"{bool((got.argmax(-1) == want.argmax(-1)).all())}")
    if not err <= 10 * spread or not bool(torch.isfinite(got).all()):
        raise AssertionError("the zero-shot logits on the GPU disagree with the CPU")


def bench_parity_probe(feature_root):
    """The linear-probe head (train_linear_head at BENCH_LP_WD on the cached
    train features) on the GPU against the CPU: within ten times the CPU's
    own spread under 1e-7 relative input noise on the features."""
    from bcosification_tpu_torch.clip_benchmark.metrics import linear_probe

    (path,) = Path(feature_root).glob("*_train_x.npy")
    x, y = np.load(path), np.load(str(path).replace("_x.npy", "_y.npy"))
    kw = dict(num_classes=int(y.max()) + 1, lr=0.1, epochs=10, batch_size=BENCH_BATCH,
              weight_decay=BENCH_LP_WD, seed=SEED)
    t0 = time.perf_counter()
    wg, bg = linear_probe.train_linear_head(x, y, device="cuda", **kw)
    gpu_s = time.perf_counter() - t0
    wc, bc = linear_probe.train_linear_head(x, y, device="cpu", **kw)
    noise = np.random.default_rng(SEED + 42).standard_normal(x.shape).astype(np.float32)
    wn, bn = linear_probe.train_linear_head(x * (1 + np.float32(1e-7) * noise), y,
                                            device="cpu", **kw)

    def flat(w, b):
        return torch.cat([w.flatten().cpu(), b.cpu()])

    err, spread = rel(flat(wg, bg), flat(wc, bc)), rel(flat(wn, bn), flat(wc, bc))
    say(f"bench probe head ({x.shape[0]} x {x.shape[1]} features, wd {BENCH_LP_WD}, 10 epochs; "
        f"{gpu_s:.2f} s on the gpu): gpu vs cpu {err:.3e} (bound {10 * spread:.3e}, ten cpu "
        "spreads under 1e-7 relative feature noise)")
    if not err <= 10 * spread:
        raise AssertionError("the probe head trained on the GPU disagrees with the CPU")


def check_bench_kernels(nets, worst):
    """K3 against its plain version at every distinct shape of one harness
    encode (fp32, batch BENCH_BATCH, pooled and attn-unpool; the c_proj with
    the linear norm, eps_outside), phase 3's fp32 bound."""
    shapes = sorted({key for net in nets for key in clip_launches(net, BENCH_BATCH, SIZE, False)})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    for name, m, k, n, _, *linear in shapes:
        x, wt, *_ = operands(m, k, n, torch.float32, gen)
        kw = dict(eps=LINEAR_NORM_EPS if any(linear) else 1e-6, eps_outside=any(linear))
        got = k3.bcos_matmul_fwd(x, wt, **kw)
        want = k3.bcos_matmul_fwd_plain(x, wt, **kw)
        torch.cuda.synchronize()
        _check(worst, name, " eps_outside" if any(linear) else "",
               f"bench M={m} K={k} N={n}", torch.float32, got, want)
        del x, wt, got, want
    return len(shapes)


def phase_bench(stream_rate, worst, exp_root):
    """Phase 16: the clip_benchmark CLI of the port on the card (see the
    module docstring). Returns the harness keys of K3's row of the kernels
    line."""
    from bcosification_tpu_torch.clip_benchmark import cli as bench_cli
    from bcosification_tpu_torch.clip_benchmark.datasets.builder import build_dataset
    from bcosification_tpu_torch.clip_benchmark.models import load_clip
    from bcosification_tpu_torch.models import captioner

    pooled, unpool = CLIP_EXPERIMENTS["pooled"][2], CLIP_EXPERIMENTS["unpool"][2]
    record = BenchRecord()
    with tempfile.TemporaryDirectory() as tmp, bench_instruments(record):
        t0 = time.perf_counter()
        roots = write_bench_trees(tmp)
        say(f"bench: wrote the seeded wds trees ({BENCH_CLS} + {BENCH_LP_TRAIN + BENCH_LP_TEST} + "
            f"{BENCH_RET} + {BENCH_SEL} JPEGs of {BENCH_JPEG}^2) in "
            f"{time.perf_counter() - t0:.1f} s")
        clf, features = f"{tmp}/clf.npy", f"{tmp}/features"

        def argv(key, tag, *extra):
            return ["--dataset", BENCH_DATASETS[key], "--dataset_root", f"{tmp}/{{dataset}}",
                    "--output", f"{tmp}/{tag}.json", "--batch_size", str(BENCH_BATCH),
                    "--feature_root", features, *extra]

        k3_pooled, k3_unpool = (clip_counts(u, False)["bcos_matmul_fwd"] for u in (False, True))
        cls_runs = [("cls pooled", ["--model_type", "bcos_clip", "--model", pooled,
                                    "--save_clf", clf], k3_pooled),
                    ("cls attn-unpool", ["--model_type", "bcos_clip", "--model", unpool,
                                         "--load_clfs", clf], k3_unpool),
                    ("cls cc3m", ["--model_type", "bcos_clip_cc3m", "--model",
                                  CC3M_EXPERIMENT[2], "--load_clfs", clf], k3_pooled),
                    # the vanilla tower (random init from SEED): no B-cos layer
                    ("cls standard_clip", ["--model_type", "standard_clip", "--model", "RN50",
                                           "--pretrained", "none", "--load_clfs", clf], 0)]
        results = {}
        for tag, extra, k3_per in cls_runs:
            results[tag] = bench_run(record, tag, argv("cls", tag, *extra), k3_per)
        build = record.runs[0]
        say(f"bench zero-shot classifier: {len(imagenet_classes)} classes x "
            f"{len(imagenet_templates)} templates = "
            f"{len(imagenet_classes) * len(imagenet_templates)} prompts in "
            f"{build.classifier_s:.2f} s: tokenizer {build.tokenize_s:.2f} s (host), fp32 text "
            f"tower {build.text_s:.2f} s (synchronised) [{CARD}]")
        cls_set = build_dataset(BENCH_DATASETS["cls"], root=str(roots["cls"]),
                                transform=build.transform)
        bench_parity_logits(build.bundle, np.load(clf),
                            np.stack([cls_set[i][0] for i in range(BENCH_PARITY_IMAGES)]))
        lp = ["--task", "linear_probe", "--model_type", "bcos_clip", "--model", pooled,
              "--val_proportion", str(BENCH_LP_VAL)]
        results["lp"] = bench_run(record, "lp", argv("lp", "lp", *lp), k3_pooled)
        results["lp cached"] = bench_run(record, "lp --skip_load",
                                         argv("lp", "lp_cached", *lp, "--skip_load"), k3_pooled)
        # the cached route has no validation loader (as in the JAX CLI): its
        # head trains on the train split alone at weight decay 0
        for tag in ("lp", "lp cached"):
            acc = results[tag][1]["metrics"]["lp_acc1"]
            if not acc >= BENCH_LP_MIN_ACC1:
                raise AssertionError(f"bench {tag}: lp_acc1 {acc} < {BENCH_LP_MIN_ACC1}")
        bench_parity_probe(features)
        model = ["--model_type", "bcos_clip", "--model", pooled]
        results["ret"] = bench_run(record, "ret", argv("ret", "ret", *model), k3_pooled)
        # phase 20's harness run: the plain CLIP ViT-B/32 at random init (no K3)
        results["ret vit"] = bench_run(record, "ret standard_clip ViT-B-32", argv(
            "ret", "ret_vit", "--model_type", "standard_clip", "--model", "ViT-B-32",
            "--pretrained", "none"), 0)
        say(f"bench standard_clip ViT-B-32 (phase 20's harness run): "
            f"{record.runs[-1].seconds:.1f} s")
        results["sel"] = bench_run(record, "sel", argv("sel", "sel", *model), k3_pooled)
        embed_dim = build.bundle.image_model.model.attnpool.c_proj.weight.shape[-1]
        head = captioner.save_captioner(captioner.GreedyCaptioner(embed_dim, 49408),
                                        f"{tmp}/head.npz")
        results["cap"] = bench_run(record, "cap", argv(
            "ret", "cap", "--task", "captioning", "--model_type", "bcos_captioner", "--model",
            pooled, "--pretrained", str(head)), k3_pooled)
        # text2concept: fit the aligner on the probe's train images, save it,
        # then classify through it from the command
        t0 = time.perf_counter()
        t2c_bundle, transform, _ = load_clip("text2concept_clip", pooled, "", device="cuda")
        ds = build_dataset(BENCH_DATASETS["lp"], root=str(roots["lp"]), transform=transform,
                           split="train")
        from bcosification_tpu_torch.data.loader import DataLoader

        aligner = t2c_bundle.text2concept.fit_aligner(DataLoader(ds, BENCH_BATCH, num_workers=4))
        aligner_path = aligner.save_aligner(f"{tmp}/aligner.npz")
        say(f"bench text2concept: fit_aligner over {len(ds)} images ({aligner.W.shape}) and "
            f"save_aligner in {time.perf_counter() - t0:.1f} s")
        results["t2c"] = bench_run(record, "cls text2concept", argv(
            "cls", "t2c", "--model_type", "text2concept_clip", "--model", pooled,
            "--pretrained", str(aligner_path), "--load_clfs", clf), k3_pooled)
        files = [str(Path(tmp) / f"{t}.json") for t in
                 ("cls pooled", "cls attn-unpool", "cls cc3m", "cls standard_clip", "lp",
                  "lp_cached", "ret", "ret_vit", "sel", "cap", "t2c")]
        bench_cli.main(["build", *files, "--output", f"{tmp}/benchmark.csv"])
        import csv

        with open(f"{tmp}/benchmark.csv") as f:
            rows = list(csv.DictReader(f))
        if len(rows) != len(files):
            raise AssertionError(f"build merged {len(rows)} of {len(files)} results")
        say(f"bench build: {len(rows)} results merged into one CSV of {len(rows[0])} columns")
        nets = [record.runs[0].bundle.image_model, record.runs[1].bundle.image_model]
        n_shapes = check_bench_kernels(nets, worst)
        say(f"bench: K3 checked in fp32 at the {n_shapes} distinct shapes of one harness encode "
            f"at batch {BENCH_BATCH}")
        per_shape = collections.Counter(clip_launches(nets[1], BENCH_BATCH, SIZE, False))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 44)
        row = time_shapes(per_shape, stream_rate, gen, tag="bench fp32 ",
                          dtype=torch.float32)["bcos_matmul_fwd"]
        launches = sum(per_shape.values())
        say(f"bench bcos_matmul_fwd per attn-unpool fp32 encode at batch {BENCH_BATCH} "
            f"({launches} launches, {row['flops'] / 1e9:.1f} GFLOP): {row['ms']:.4f} ms; bound "
            f"{1e3 * row['bound_s']:.4f} ms at the data-sheet rates (3xTF32 at 495 TFLOP/s, 3350 "
            f"GB/s), {fp32_cores_ms(row):.4f} ms at 67 TFLOP/s fp32, "
            f"{1e3 * row['measured_bound_s']:.4f} ms at the measured "
            f"{stream_rate / 1e9:.1f} GB/s; plain {row['plain_ms']:.4f} ms, torch.matmul "
            f"{row['library_ms']:.4f} ms; tma_operands padded {k12.tma_operands.padded} "
            f"calls [{CARD}]")
        say("bench summary: " + "; ".join(f"{r.tag} {r.img_s:.1f} img/s" for r in record.runs
                                          if r.images) + f" [{CARD}]")
        del nets, record
    return {"bench_launches": launches, "bench_ms": row["ms"],
            "bench_bound_ms": 1e3 * row["bound_s"], "bench_bound_fp32_cores_ms": fp32_cores_ms(row),
            "bench_plain_ms": row["plain_ms"],
            "bench_library_ms": row["library_ms"], "bench_dtype": "float32"}


# --------------------------------------------------------------------------
# 17: the B-cos v2 model zoo (models/pretrained.py)
# --------------------------------------------------------------------------
# entry point -> its hand-scheduled explanation pass
ZOO = {"resnet50": fast_resnet, "densenet121": fast_densenet,
       "simple_vit_l_patch16_224": fast_vit}
ZOO_TAGS = {"resnet50": "zoo_resnet50", "densenet121": "zoo_densenet121",
            "simple_vit_l_patch16_224": "zoo_vit_l16"}
# phase 18's entry points, and every zoo entry's hand-scheduled pass
ZOO_VGG_CONVNEXT = {"vgg16_bnu": fast_vgg, "convnext_tiny": fast_convnext,
                    "convnext_base_bnu": fast_convnext}
ZOO_TAGS.update({"vgg16_bnu": "zoo_vgg16_bnu", "convnext_tiny": "zoo_convnext_tiny",
                 "convnext_base_bnu": "zoo_convnext_base_bnu"})
ZOO_PASSES = {**ZOO, **ZOO_VGG_CONVNEXT}
VIT_L_ROWS = BATCH * (SIZE // 16) ** 2  # 25088 token rows at batch 128
# (label, M, K, N, eps_outside) at batch 128, 224x224, as the zoo calls K3
# and K2 (K2 with the bare cotangent: the position norm's or LayerNorm's
# backward runs before it): the ResNet-50's layer1 conv1, conv3 and
# stride-1 downsample, a layer4 conv3 and the classifier; the DenseNet-121's
# first conv1 and transition 3; ViT-L/16's linears and head
ZOO_CHECK_SHAPES = [
    ("zoo resnet50 layer1.conv1", 401408, 64, 64, False),
    ("zoo resnet50 layer1.conv3", 401408, 64, 256, False),
    ("zoo resnet50 layer2.conv1", 401408, 256, 128, False),
    ("zoo resnet50 layer4.conv3", 6272, 512, 2048, False),
    ("zoo resnet50 fc", 6272, 2048, 1000, False),
    ("zoo densenet121 b1.l1.conv1", 401408, 64, 128, False),
    ("zoo densenet121 transition3", 25088, 1024, 512, False),
    ("zoo vit_l patch embedding", VIT_L_ROWS, 1536, 1024, True),
    ("zoo vit_l linear1", VIT_L_ROWS, 1024, 4096, True),
    ("zoo vit_l linear2", VIT_L_ROWS, 4096, 1024, True),
    ("zoo vit_l head", BATCH, 1024, 1000, True),
]
# phase 18's: ConvNeXt-T's four stages and classifier, ConvNeXt-atto's first
# and last stages (K and N of 40 and 80: below one 64-deep bf16 and one
# 32-deep fp32 stage, the TMA boxes filled with zeros past K and N),
# ConvNeXt-B's first stage, VGG-16's two 1x1 classifier convs
ZOO_VGG_CONVNEXT_CHECK_SHAPES = [
    ("zoo convnext_tiny stage0 block_2", 401408, 96, 384, False),
    ("zoo convnext_tiny stage0 block_3", 401408, 384, 96, False),
    ("zoo convnext_tiny stage1 block_2", 100352, 192, 768, False),
    ("zoo convnext_tiny stage2 block_3", 25088, 1536, 384, False),
    ("zoo convnext_tiny stage3 block_2", 6272, 768, 3072, False),
    ("zoo convnext_tiny classifier", 6272, 768, 1000, False),
    ("zoo convnext_atto stage0 block_2", 401408, 40, 160, False),
    ("zoo convnext_atto stage0 block_3", 401408, 160, 40, False),
    ("zoo convnext_atto stage3 block_3", 6272, 1280, 320, False),
    ("zoo convnext_atto classifier", 6272, 320, 1000, False),
    ("zoo convnext_base stage0 block_3", 401408, 512, 128, False),
    ("zoo vgg16 classifier_1", 6272, 4096, 4096, False),
    ("zoo vgg16 classifier_2", 6272, 4096, 1000, False),
]
ZOO_EXPORT_BATCH = 8
# the zoo nets' export round trips at a cut depth (C7: export time): the
# ResNet-50 and the DenseNet-121 cut to their first two stages, at full width
ZOO_EXPORT_RESNET_LAYERS = (1, 1)
ZOO_EXPORT_DENSENET_BLOCKS = (2, 1)  # every 1x1's Cin a multiple of 8: 64, 96, 128, 64, 96


def check_zoo_kernels(worst, shapes=ZOO_CHECK_SHAPES):
    """K3 and K2 against their plain versions at ``shapes``, in both dtypes
    with phase 3's bounds, as the zoo calls them."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for label, m, k, n, eps_outside in shapes:
            x, wt, _, _, ct = operands(m, k, n, dtype, gen)
            kw = dict(eps=LINEAR_NORM_EPS if eps_outside else 1e-6, eps_outside=eps_outside)
            variant = " eps_outside" if eps_outside else ""
            results = [
                ("bcos_matmul_fwd", variant, k3.bcos_matmul_fwd(x, wt, **kw),
                 k3.bcos_matmul_fwd_plain(ref(x), ref(wt), **kw)),
                ("bcos_conv1x1_bwd_explain", variant,
                 k12.conv1x1_bwd_explain(x, wt, ct, None, None, relu=False, **kw),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), None, None,
                                               relu=False, **kw)),
            ]
            torch.cuda.synchronize()
            for name, variant_, got, want in results:
                _check(worst, name, variant_, label, dtype, got, want)
            del x, wt, ct, results


def zoo_counts(net, explain):
    """The launches of one forward (or fwd+explain) of a zoo net: K3 (and K2)
    at every stride-1 1x1 B-cos conv and bias-free B-cos linear; no K1."""
    n = sum(1 for mod in net.modules()
            if (isinstance(mod, BcosConv2d) and mod.kernel_size == (1, 1)
                and mod.stride == (1, 1) and mod.groups == 1 and mod.bias is None)
            or (isinstance(mod, BcosLinear) and mod.bias is None and mod.max_out == 1))
    return {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": n if explain else 0,
            "bcos_matmul_fwd": n, "stream_add": 0}


@contextlib.contextmanager
def recorded_launches():
    """[(kernel, M, K, N, relu, eps_outside)] of every K3 and K2 launch made
    inside the context (the wrappers' direct CUDA calls, recorded)."""
    seen = []
    fwd, bwd = k3._bcos_matmul_fwd_cuda, k12._conv1x1_bwd_cuda

    def rec_fwd(x, wt, eps, eps_outside):
        seen.append(("bcos_matmul_fwd", x.shape[0], x.shape[1], wt.shape[0], False,
                     bool(eps_outside)))
        return fwd(x, wt, eps, eps_outside)

    def rec_bwd(x2, wt, ct, a, mult, relu, eps, eps_outside):
        seen.append(("bcos_conv1x1_bwd_explain", x2.shape[0], x2.shape[1], wt.shape[0],
                     bool(relu), bool(eps_outside)))
        return bwd(x2, wt, ct, a, mult, relu, eps, eps_outside)

    k3._bcos_matmul_fwd_cuda, k12._conv1x1_bwd_cuda = rec_fwd, rec_bwd
    try:
        yield seen
    finally:
        k3._bcos_matmul_fwd_cuda, k12._conv1x1_bwd_cuda = fwd, bwd


def zoo_parity(name, net, x2):
    """fp32, 2 images: the fast pass's logits and W on the GPU against the
    CPU, and the generic autograd W on the GPU against the fast pass: W
    within ten times the CPU's own spread under 1e-7 relative input noise
    (for the CNNs with PyTorch's own CUDA convs in place of cuDNN's; with
    cuDNN's within phase 4's 1e-3), the pre-logits within 1e-4, the argmax
    identical. Returns the pre-logit RMS."""
    fast = ZOO_PASSES[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lg, sg, wg = fast.fast_dynamic_linear_weights(net, x2)
    lm, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x2)
    w_native = None
    if fast is not fast_vit:
        torch.backends.cudnn.enabled = False
        try:
            _, _, w_native = fast.fast_dynamic_linear_weights(net, x2)
        finally:
            torch.backends.cudnn.enabled = True
    cpu = copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    lc, sc, wc = fast.fast_dynamic_linear_weights(cpu, x2.cpu(), device="cpu")
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 61))
    _, _, wn = fast.fast_dynamic_linear_weights(cpu, x2.cpu() * (1 + 1e-7 * noise),
                                                device="cpu")
    cpu_s = time.perf_counter() - t0
    del cpu
    spread = rel(wn, wc)
    bias = net.logit_layer.logit_bias

    def pre_rel(a, b):
        a, b = a.double().cpu() - bias, b.double().cpu() - bias
        return float((a - b).abs().max() / b.abs().max())

    checks = {"W gpu vs cpu" + (" (cudnn convs)" if w_native is not None else ""):
              (rel(wg, wc), 1e-3 if w_native is not None else 10 * spread),
              "W module path vs fast pass (gpu)": (rel(wm, wg), 10 * spread),
              "pre-logit gpu vs cpu (max rel)": (pre_rel(lg, lc), 1e-4),
              "pre-logit module path vs fast pass (gpu, max rel)": (pre_rel(lm, lg), 1e-4)}
    if w_native is not None:
        checks["W gpu vs cpu (torch convs)"] = (rel(w_native, wc), 10 * spread)
    rms = float((lc.double() - bias).pow(2).mean().sqrt())
    say(f"zoo {name} parity: pre-logit RMS {rms:.4g} on the probe (a vanishing net shows "
        f"here); W on the cpu under 1e-7 relative input noise: {spread:.3e}; the cpu passes "
        f"took {cpu_s:.1f} s")
    for key, (val, bound) in checks.items():
        say(f"zoo {name} parity {key}: {val:.3e} (bound {bound:.3e})"
            + (f" = {val / spread:.2f} x the spread" if spread else ""))
    same = bool((sg.cpu() == sc).all() and (sm == sg).all())
    say(f"zoo {name} parity argmax identical: {same}")
    if not same or any(not val <= bound for val, bound in checks.values()):
        raise AssertionError(f"zoo {name} parity failed")
    if not all(torch.isfinite(t).all() for t in (lg, wg)) or wg.shape != x2.shape:
        raise AssertionError(f"zoo {name} outputs are not finite or mis-shaped")
    return rms


def zoo_throughput(name, net, x):
    """Forward-only and fwd+explain (fast pass; ResNet-50 also autograd)
    images/s at batch 128, bf16, each with its launch counts (K3 and K2 of
    every call recorded), host issue time, peak memory, the card's busy
    time and its top kernels."""
    fast = ZOO_PASSES[name]

    def forward():
        with torch.no_grad():
            return net(x)

    calls = [("forward-only", forward, False),
             ("fwd+explain (fast pass)", lambda: fast.fast_dynamic_linear_weights(net, x), True)]
    if name == "resnet50":
        calls.append(("fwd+explain (autograd)", lambda: dynamic_linear_weights(
            lambda t: net(t, explain=True), x), True))
    out, launches = {}, []
    for what, fn, explain_ in calls:
        fn()
        with recorded_launches() as seen:
            result, counts = counted(fn)
        check_counts(f"zoo {name} {what}", counts, zoo_counts(net, explain_))
        outs = result if isinstance(result, tuple) else (result,)
        if not all(torch.isfinite(v).all() for v in outs if v.is_floating_point()):
            raise AssertionError(f"zoo {name} {what}: outputs are not finite")
        if what == "fwd+explain (fast pass)":
            launches = list(seen)
        del result, outs
        ms, n_calls, host, peak_gb = windowed(fn)
        busy, top = device_profile(fn, 3)
        say(f"zoo {name} throughput {what}: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per batch "
            f"of {BATCH}, one window of {n_calls} calls; the host issues one call in {host:.2f} "
            f"ms; peak memory of one call {peak_gb:.2f} GB; launches {counts}) [{CARD}]")
        say(f"zoo {name} {what}: card busy {busy or 0:.2f} ms per call (torch.profiler); top "
            "kernels: " + "; ".join(f"{k[:60]} {t:.2f} ms" for k, t in top))
        out[what] = BATCH / ms * 1e3
    return out, launches


def zoo_export(name, x2):
    """export_explain of the entry's net at a cut depth (ResNet-50 and
    DenseNet-121 their first two stages, ZOO_EXPORT_RESNET_LAYERS and
    ZOO_EXPORT_DENSENET_BLOCKS, a ConvNeXt its first two
    stages of one block each: the stem, a block, the
    downsampling, a block, the head, prepared as phase 18's nets; random
    init from SEED) in bf16, loaded from bytes: at batch ZOO_EXPORT_BATCH its
    W and logits equal to the eager pass's (1e-6 relative), the argmax and
    the launches identical. Returns the export seconds."""
    fast = ZOO_PASSES[name]
    if name == "resnet50":
        net = resnet.BcosResNet("bottleneck", ZOO_EXPORT_RESNET_LAYERS, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(SEED))
        net = net.eval().requires_grad_(False)
    elif name == "densenet121":
        net = BcosDenseNet(block_config=ZOO_EXPORT_DENSENET_BLOCKS, with_logit_layer=True,
                           device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED))
        net = net.eval().requires_grad_(False)
    else:  # a ConvNeXt
        with abstract_init():
            full = pretrained.load_model(name, pretrained=False)
        first, second = full.block_setting[:2]
        blocks = [convnext.CNBlockConfig(first.input_channels, first.out_channels, 1),
                  convnext.CNBlockConfig(second.input_channels, None, 1)]
        net = convnext.BcosConvNeXt(
            blocks, norm_layer=NoBias(type(full.stem_norm)), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        net = net.eval().requires_grad_(False)
        zoo_prepare(net, x2[:1])
    t0 = time.perf_counter()
    program = serving.load_serialized(serving.export_explain(net, input_size=SIZE,
                                                             dtype=torch.bfloat16))
    export_s = time.perf_counter() - t0
    x = _batch128(x2, SEED + 62)[:ZOO_EXPORT_BATCH]
    (logits, sel, w), counts = counted(lambda: program.call(x))
    (le, se, we), counts_e = counted(lambda: fast.fast_dynamic_linear_weights(net, x))
    bias = net.logit_layer.logit_bias
    checks = {"W loaded vs eager (rel)": (rel(w.float(), we.float()), 1e-6),
              "pre-logit loaded vs eager (rel)": (rel(logits.double() - bias,
                                                      le.double() - bias), 1e-6)}
    say(f"zoo {name} serving (cut depth): export_explain and load {export_s:.1f} s; launches "
        f"{counts} (eager {counts_e}); " + ", ".join(
            f"{key} {val:.3e} (bound {bound:.0e})" for key, (val, bound) in checks.items()))
    if (not torch.equal(sel, se) or counts != counts_e
            or any(not val <= bound for val, bound in checks.values())):
        raise AssertionError(f"the loaded zoo {name} program disagrees with the eager pass")
    return export_s


def zoo_weight_paths(nets, x2):
    """load_model(name) from an npz of the JAX export format that this
    phase writes to a temporary BCOS_WEIGHTS_DIR (the ResNet-50 and the
    DenseNet-121: the same weights and logits); convert_release_checkpoint
    of seeded reference-layout .pth files of resnet50 in both released
    flavours: the position-norm one gives the same logits as its source;
    the BN one (running statistics) rebuilds the net with uncentered BN,
    whose forward folds every 1x1 but the classifier into K1 and whose
    fast pass runs K1, K2 and K3."""
    old = os.environ.get("BCOS_WEIGHTS_DIR")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            os.environ["BCOS_WEIGHTS_DIR"] = tmp
            for name in ("resnet50", "densenet121"):
                net = nets[name]
                flat = {}
                for collection, tree in to_jax_variables(net).items():
                    stack = [((collection,), tree)]
                    while stack:
                        path, node = stack.pop()
                        for key, value in node.items():
                            if isinstance(value, dict):
                                stack.append((path + (key,), value))
                            else:
                                flat["/".join(path + (key,))] = value
                t0 = time.perf_counter()
                np.savez(Path(tmp) / f"{name}.npz", **flat)
                loaded = pretrained.load_model(name, seed=SEED + 1)
                load_s = time.perf_counter() - t0
                same = all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(),
                                                             net.state_dict().values()))
                with torch.no_grad():
                    err = rel(loaded(x2), net(x2))
                say(f"zoo {name}: load_model from $BCOS_WEIGHTS_DIR/{name}.npz in {load_s:.1f} s "
                    f"(npz written and read): weights identical: {same}, logits rel {err:.3e}")
                same = same and err <= 1e-6
                if not same:
                    raise AssertionError(f"load_model({name!r}) did not load the npz")
                del loaded
        finally:
            if old is None:
                os.environ.pop("BCOS_WEIGHTS_DIR", None)
            else:
                os.environ["BCOS_WEIGHTS_DIR"] = old
        net = nets["resnet50"]
        bnu = pretrained.load_model("resnet50", pretrained=False, seed=SEED + 2,
                                    norm_layer=NoBias(BatchNormUncentered2d))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 63)
        for mod in bnu.modules():
            if isinstance(mod, BatchNormUncentered2d):
                mod.running_var.copy_(torch.rand(mod.running_var.shape, device="cuda",
                                                 generator=gen) + 0.5)
        for flavour, source in (("position norm", net), ("uncentered BN", bnu)):
            sd = release_import.release_state_dict(source, "resnet50")
            for key in [k for k in sd if k.endswith("running_var")]:
                sd[key[:-len("var")] + "mean"] = torch.randn(sd[key].shape)
            path = Path(tmp) / "resnet_50-release.pth"
            torch.save(sd, path)
            t0 = time.perf_counter()
            model, _ = release_import.convert_release_checkpoint("resnet50", path,
                                                                 return_model=True)
            convert_s = time.perf_counter() - t0
            with torch.no_grad():
                got, counts = counted(lambda: model(x2))
                want = source(x2)
            k1 = sum(1 for n, mod in model.named_modules()
                     if isinstance(mod, BcosConv2d) and mod.kernel_size == (1, 1) and n != "fc")
            bn = flavour == "uncentered BN"
            expected = ({"bcos_conv1x1_fwd": k1, "bcos_conv1x1_bwd_explain": 0,
                         "bcos_matmul_fwd": 1, "stream_add": 0} if bn
                        else zoo_counts(model, False))
            err = rel(got, want)
            say(f"zoo resnet50 release checkpoint ({flavour}, {len(sd)} tensors): converted "
                f"from .pth in {convert_s:.1f} s; norms "
                f"{type(model.bn1).__name__}; forward launches {counts}; logits against the "
                f"source's: rel {err:.3e} (bound 1e-6)")
            check_counts(f"zoo release {flavour} forward", counts, expected)
            if not err <= 1e-6 or isinstance(model.bn1, BatchNormUncentered2d) != bn:
                raise AssertionError(f"the {flavour} release checkpoint did not convert")
            if bn:
                (lf, _, wf), counts = counted(
                    lambda: fast_resnet.fast_dynamic_linear_weights(model, x2))
                say(f"zoo resnet50 release checkpoint (uncentered BN): fast pass launches "
                    f"{counts}; W finite: {bool(torch.isfinite(wf).all())}")
                check_counts("zoo release uncentered BN fast pass", counts,
                             {"bcos_conv1x1_fwd": k1, "bcos_conv1x1_bwd_explain": k1 + 1,
                              "bcos_matmul_fwd": 1, "stream_add": 0})
                if not (torch.isfinite(lf).all() and torch.isfinite(wf).all()):
                    raise AssertionError("the BN-flavoured zoo ResNet-50's W is not finite")
            del model


def phase_zoo(x2, stream_rate, worst):
    """Phase 17: the B-cos v2 model zoo at full width: load_model of
    resnet50, densenet121 and simple_vit_l_patch16_224 (random init from
    SEED, no calibration: the position norm and the LayerNorm renormalise
    every layer). Returns the zoo keys of K2's and K3's rows of the kernels
    line."""
    check_zoo_kernels(worst)
    nets, keys, summary = {}, {}, []
    for name in ZOO:
        net = zoo_build(name)
        summary.append(zoo_net(name, net, x2, stream_rate, keys))
        nets[name] = net
    zoo_weight_paths(nets, x2)
    say("zoo summary: " + "; ".join(summary) + f" [{CARD}]")
    return keys


def zoo_build(name, **kw):
    """load_model(name) on the card (random init from SEED), with its build
    seconds, parameters and launches per forward printed."""
    t0 = time.perf_counter()
    net = pretrained.load_model(name, pretrained=False, seed=SEED, **kw)
    build_s = time.perf_counter() - t0
    say(f"zoo {name}: built on the card in {build_s:.1f} s "
        f"({sum(p.numel() for p in net.parameters()) / 1e6:.1f} M parameters; launches per "
        f"forward {zoo_counts(net, False)})")
    return net


def zoo_net(name, net, x2, stream_rate, keys):
    """One zoo net's parity, throughput, kernel times at every shape of one
    fwd+explain (their rows added to ``keys`` under the net's tag) and,
    unless ZOO_UNEXPORTED names it, export round trip. Returns its
    summary."""
    rms = zoo_parity(name, net, x2)
    rates, launches = zoo_throughput(name, net, _batch128(x2, SEED + 64))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 65)
    rows = time_shapes(collections.Counter(launches), stream_rate, gen, tag=f"zoo {name} ")
    export_s = None if name in ZOO_UNEXPORTED else zoo_export(name, x2)
    counts = zoo_counts(net, True)
    tag = ZOO_TAGS[name]
    for kernel, r in rows.items():
        what = "explanation" if kernel == "bcos_conv1x1_bwd_explain" else "forward"
        say(f"zoo {kernel} per {name} {what} ({counts[kernel]} launches): {r['ms']:.4f} ms; "
            f"bound {1e3 * r['bound_s']:.4f} ms at the data-sheet rate "
            f"({'FLOPs' if r['flop_s'] >= r['byte_s'] else 'bytes'}), "
            f"{1e3 * r['measured_bound_s']:.4f} ms at the measured "
            f"{stream_rate / 1e9:.1f} GB/s; plain {r['plain_ms']:.4f} ms, torch.matmul "
            f"{r['library_ms']:.4f} ms [{CARD}]")
        keys.setdefault(kernel, {}).update({
            f"{tag}_launches": counts[kernel], f"{tag}_ms": r["ms"],
            f"{tag}_bound_ms": 1e3 * r["bound_s"], f"{tag}_plain_ms": r["plain_ms"],
            f"{tag}_library_ms": r["library_ms"]})
    return (f"{name}: pre-logit RMS {rms:.3g}, " + ", ".join(
        f"{what} {v:.1f} img/s" for what, v in rates.items())
        + ("" if export_s is None else f", export {export_s:.1f} s"))


# --------------------------------------------------------------------------
# 18: the zoo's VGG and ConvNeXt entries (models/vgg.py, models/convnext.py)
# --------------------------------------------------------------------------
# K3 per forward (K2 as many per explanation), K1 none
ZOO_VGG_CONVNEXT_K3 = {"vgg16_bnu": 2, "convnext_tiny": 37, "convnext_base_bnu": 73}
# not exported on the card (an export round trip takes 15-40 s of the
# script's time limit): convnext_base_bnu's cut net runs convnext_tiny's
# program (fast_convnext) with the uncentered BN, phase 17's zoo CNNs the
# position norm; the VGG's export_explain round trip runs in the CPU tests;
# the zoo ViT-L is a vit_final net on fast_vit, whose programs phase 14
# exports for the B-cos ViT-B of vit_final at the same depth
ZOO_UNEXPORTED = ("vgg16_bnu", "convnext_tiny", "simple_vit_l_patch16_224")


def zoo_prepare(net, probe):
    """A random-init VGG or ConvNeXt made fit to compare: each ConvNeXt
    block's layer_scale drawn from SEED in +-[0.1, 1] (at its init of 1e-6
    every block is the identity to 1e-6, so a broken K3 would pass); each
    uncentered BN's gamma, in forward order, divided by the RMS of the
    norm's output on ``probe`` (a random-init b=2 net contracts ~1/sqrt(9
    Cin) per conv), then the last one's by the pre-logit RMS (VGG's
    norm-free classifier contracts ~1e6-fold). Returns the pre-logit RMS."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    bias = net.logit_layer.logit_bias
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, convnext.CNBlock):
                s = torch.rand(mod.layer_scale.shape, device="cuda", generator=gen) * 0.9 + 0.1
                sign = torch.randint(0, 2, s.shape, device="cuda", generator=gen) * 2 - 1
                mod.layer_scale.copy_(s * sign)
        bns = [m for m in net.modules() if isinstance(m, BatchNormUncentered2d)]
        for bn in bns:
            bn.weight.div_(_output_rms(net, probe, bn))
        if bns:
            bns[-1].weight.div_(float((net(probe).double() - bias).pow(2).mean().sqrt()))
        return float((net(probe).double() - bias).pow(2).mean().sqrt())


def vgg_layer_rms(x2):
    """The plain (norm-free) vgg16 at random init: the RMS of each conv's
    output on one probe image, printed (it contracts ~1/sqrt(9 Cin) per
    conv, so its W is no check of the kernels: phase 18 holds vgg16_bnu)."""
    net = pretrained.load_model("vgg16", pretrained=False, seed=SEED)
    convs = [(n, m) for n, m in net.named_modules() if isinstance(m, BcosConv2d)]
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, float(out.double().pow(2).mean().sqrt())))
        for n, m in convs]
    try:
        with torch.no_grad():
            net(x2[:1])
    finally:
        for h in hooks:
            h.remove()
    say("zoo vgg16 (no norms) per-layer output RMS on the probe: " + ", ".join(
        f"{n} {seen[n]:.3g}" for n, _ in convs))
    del net


def zoo_release_round_trip(nets, x2):
    """convert_release_checkpoint of seeded reference-layout .pth files
    (release_state_dict of phase 18's nets, the uncentered BNs' running
    means added as the reference keeps them): vgg16_bnu, convnext_tiny (the
    position norm) and a convnext_tiny_bnu under the name convnext_tiny (the
    running statistics rebuild it with uncentered BN): each equal to its
    source in the pre-logits (1e-6 relative), its modules of the source's
    types, its forward on K3 alone."""
    bnu = zoo_build("convnext_tiny_bnu")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    for mod in bnu.modules():
        if isinstance(mod, BatchNormUncentered2d):
            mod.running_var.copy_(torch.rand(mod.running_var.shape, device="cuda",
                                             generator=gen) + 0.5)
    zoo_prepare(bnu, x2[:1])
    sources = (("vgg16_bnu", "vgg16_bnu", nets["vgg16_bnu"]),
               ("convnext_tiny", "convnext_tiny", nets["convnext_tiny"]),
               ("convnext_tiny", "convnext_tiny_bnu", bnu))
    with tempfile.TemporaryDirectory() as tmp:
        for name, what, source in sources:
            sd = release_import.release_state_dict(source, name)
            for key in [k for k in sd if k.endswith("running_var")]:
                sd[key[:-len("var")] + "mean"] = torch.randn(sd[key].shape)
            path = Path(tmp) / f"{what}-release.pth"
            torch.save(sd, path)
            t0 = time.perf_counter()
            model, _ = release_import.convert_release_checkpoint(name, path, return_model=True)
            convert_s = time.perf_counter() - t0
            with torch.no_grad():
                got, counts = counted(lambda: model(x2))
                want = source(x2)
            bias = source.logit_layer.logit_bias
            err = rel(got.double() - bias, want.double() - bias)
            types = {type(m) for m in model.modules()}
            say(f"zoo release checkpoint {what} as {name!r} ({len(sd)} tensors): converted from "
                f".pth in {convert_s:.1f} s; uncentered BN: "
                f"{BatchNormUncentered2d in types}; forward launches {counts}; pre-logits "
                f"against the source's: rel {err:.3e} (bound 1e-6)")
            check_counts(f"zoo release {what} forward", counts, zoo_counts(source, False))
            if not err <= 1e-6 or types != {type(m) for m in source.modules()}:
                raise AssertionError(f"the {what} release checkpoint did not convert")
            del model


def phase_zoo_vgg_convnext(x2, stream_rate, worst):
    """Phase 18: load_model of vgg16_bnu, convnext_tiny and convnext_base_bnu
    at full width (random init from SEED, ``zoo_prepare``d): phase 17's
    checks, timings and export for each, the plain vgg16's per-layer RMS,
    and the release round trips. Returns the keys of K2's and K3's rows of
    the kernels line."""
    check_zoo_kernels(worst, ZOO_VGG_CONVNEXT_CHECK_SHAPES)
    if k12.tma_operands.padded:
        raise AssertionError(f"{k12.tma_operands.padded} phase 18 kernel checks padded "
                             "their operands")
    vgg_layer_rms(x2)
    nets, keys, summary = {}, {}, []
    for name in ZOO_VGG_CONVNEXT:
        net = zoo_build(name)
        k3 = ZOO_VGG_CONVNEXT_K3[name]
        check_counts(f"zoo {name} per explanation", zoo_counts(net, True),
                     {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": k3,
                      "bcos_matmul_fwd": k3, "stream_add": 0})
        say(f"zoo {name}: prepared, pre-logit RMS {zoo_prepare(net, x2[:1]):.3g} on the probe")
        summary.append(zoo_net(name, net, x2, stream_rate, keys))
        nets[name] = net
    zoo_release_round_trip(nets, x2)
    say("zoo VGG/ConvNeXt summary: " + "; ".join(summary) + f" [{CARD}]")
    return keys


# --------------------------------------------------------------------------
# 19: the training options no grid config sets
# --------------------------------------------------------------------------
OPTIONS_ACCUM, OPTIONS_MICRO_STEPS = 2, 4  # 6b: 4 micro-batches of 64 in the fit, 2 updates
OPTIONS_WINDOW = 3  # timed optimizer steps (6b) and steps (6c)
OPTIONS_B_STEPS = 3  # the steps of each learnable-b Trainer.fit
B_VARIANTS = {  # bcosify_args of the learnable-b variants (6c)
    "learn_b": {"learn_b": True},
    "clamping + manual_optim": {"clamping": True, "manual_optim": True},  # SGD, lr 0.05
    "linear_b": {"clamping": True, "linear_b": True},
}
NO_KERNEL_COUNTS = {"bcos_conv1x1_fwd": 0, "bcos_conv1x1_bwd_explain": 0,
                    "bcos_matmul_fwd": 0, "stream_add": 0}


def options_batch(seed, n=TRAIN_BATCH, size=SIZE, classes=1000):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    image = torch.rand((n, size, size, 3), device="cuda", generator=gen)
    return {"image": torch.cat([image, 1.0 - image], dim=-1),
            "label": torch.randint(0, classes, (n,), device="cuda", generator=gen)}


def options_net(bargs, calibrated):
    """The recipe's bcosified ResNet-50 with ``bargs`` added to its
    bcosify_args and its model config: the weights and BN statistics of
    ``calibrated`` (phase 4's net, random init from SEED, BN gammas
    calibrated), a learnable b at its initial value."""
    config = {**FLAGSHIP, "bcosify_args": {**FLAGSHIP["bcosify_args"], **bargs}}
    net = build_bcosified_resnet(config, seed=SEED)
    missing, unexpected = net.load_state_dict(calibrated.state_dict(), strict=False)
    if unexpected or not all(k.endswith(".b") for k in missing):
        raise AssertionError(f"{bargs}: state dict keys missing {missing}, unexpected "
                             f"{unexpected}")
    return net, config


def options_experiment(save_dir, model_config, ema=True, **extra):
    """Phase 8's resnet_50 recipe on ``model_config``."""
    exp = train_experiment(save_dir, UniformOffLabelsBCEWithLogitsLoss())
    exp.config["model"] = model_config
    if not ema:
        del exp.config["ema"]
    exp.config.update(extra)
    return exp


def fit_printing(trainer, *args, **kwargs):
    """(Trainer.fit(*args, **kwargs), what it printed); the lines are said
    too."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = trainer.fit(*args, **kwargs)
    torch.cuda.synchronize()
    for line in out.getvalue().splitlines():
        say(f"  | {line}")
    return state, out.getvalue()


def call_window(fn, calls, what):
    """(ms per call, card busy ms or None) of ``calls`` calls of ``fn`` in a
    row between two CUDA events, the card's busy time from torch.profiler
    over 2 more; said with the median host ms per call."""
    host = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        host.append(1e3 * (time.perf_counter() - t0))
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / calls
    busy, top = device_profile(fn, 2)
    say(f"{what}: {ms:.2f} ms per call ({calls} in a row; the host issues one in "
        f"{statistics.median(host):.2f} ms, median); the card busy "
        + ("not measured (no device time in the trace)" if busy is None else
           f"{busy:.2f} ms per call (torch.profiler over 2 calls; top: "
           + ", ".join(f"{n[:40]} {k:.2f}" for n, k in top[:3]) + ")") + f" [{CARD}]")
    return ms, busy


def accumulation_parity():
    """Two fp32 micro-batches of the accumulated recipe step (k = 2, AGC,
    Adam) of the small flagship on the card and on the CPU: Adam's first
    moment after the one update, the card's distance from the CPU's
    against ten CPU spreads (the CPU's own distance under 1e-7 relative
    input noise). Returns (value, bound)."""
    small = build_bcosified_resnet({**FLAGSHIP, "name": "resnet50"}, num_classes=10,
                                   inplanes=8, layers=("bottleneck", (1, 1)), seed=SEED)
    batches = [options_batch(SEED + 72 + i, n=2, size=32, classes=10) for i in range(2)]
    calibrate(small, batches[0]["image"][:1])
    recipe = train_experiment(".", UniformOffLabelsBCEWithLogitsLoss()).config
    noise = torch.randn((2, 32, 32, 6), generator=torch.Generator().manual_seed(SEED + 74))

    def first_moment(dev, noisy):
        state = steps_lib.create_train_state(small, recipe["optimizer"].create, device=dev)
        step = steps_lib.make_train_step(recipe["criterion"], 1e-4, use_agc=True,
                                         accumulate=OPTIONS_ACCUM)
        for b in batches:
            image = b["image"].to(dev)
            if noisy:
                image = image * (1 + 1e-7 * noise.to(dev))
            step(state, {"image": image, "label": b["label"].to(dev)})
        return torch.cat([state.optimizer.state[p]["exp_avg"].double().cpu().flatten()
                          for p in state.optimizer.param_groups[0]["params"]])

    gpu, cpu = first_moment("cuda", False), first_moment("cpu", False)
    return rel(gpu, cpu), 10 * rel(first_moment("cpu", True), cpu)


def options_accumulation(calibrated, root):
    """6b and 6d: Trainer.fit of the recipe with accumulate_grad_batches 2
    over 4 micro-batches of 64 (bf16 amp) with the TensorBoard logger
    (every step), --profile_dir, --debug and explanation logging, and what
    those wrote; then the accumulated step alone (K3 per optimizer step, one
    update per 2 micro-batches, its time) and the fp32 parity."""
    from bcosification_tpu_torch.training.loggers import read_events
    from bcosification_tpu_torch.training.trainer import param_hash

    net, config = options_net({}, calibrated)
    exp = options_experiment(root / "accumulate", config,
                             trainer=dict(max_epochs=1, accumulate_grad_batches=OPTIONS_ACCUM))
    batch = options_batch(SEED + 70)
    trainer = Trainer(exp, {"amp": True, "tensorboard_logger": True, "log_every_n_steps": 1,
                            "profile_dir": str(root / "profile"), "debug": True})
    t0 = time.perf_counter()
    reset_launch_counts()
    state, printed = fit_printing(trainer, net, RepeatedBatch(batch, OPTIONS_MICRO_STEPS),
                                  explanation_logging=True)
    counts = launch_counts()
    fit_s = time.perf_counter() - t0
    evals = 3  # the initial, the epoch's and the EMA validation: one forward each
    want = {"bcos_conv1x1_fwd": 36 * evals + EXPLAIN_COUNTS["bcos_conv1x1_fwd"],
            "bcos_conv1x1_bwd_explain": EXPLAIN_COUNTS["bcos_conv1x1_bwd_explain"],
            "bcos_matmul_fwd": (TRAIN_STEP_COUNTS["bcos_matmul_fwd"] * OPTIONS_MICRO_STEPS
                                + evals + EXPLAIN_COUNTS["bcos_matmul_fwd"]),
            "stream_add": 0}
    say(f"options 6b: Trainer.fit, accumulate_grad_batches {OPTIONS_ACCUM}, "
        f"{OPTIONS_MICRO_STEPS} micro-batches of {TRAIN_BATCH} (bf16 amp), with the "
        f"TensorBoard logger, --profile_dir, --debug and explanation logging: {fit_s:.1f} s; "
        f"launches {counts} (the explanation logger's fast pass among them: {EXPLAIN_COUNTS})")
    check_counts("accumulated Trainer.fit", counts, want)
    opt_steps = {int(s["step"]) for s in state.optimizer.state.values()}
    if state.step != OPTIONS_MICRO_STEPS or opt_steps != {OPTIONS_MICRO_STEPS // OPTIONS_ACCUM}:
        raise AssertionError(f"accumulated fit: step {state.step}, optimizer steps {opt_steps}")

    events = read_events(trainer.loggers[0].path)  # checks every record's CRCs
    step_events = [e["step"] for e in events if "train_loss_step" in e["scalars"]]
    tags = sorted({t for e in events for t in [*e["scalars"], *e["images"]]})
    say(f"options 6d: TensorBoard event file {trainer.loggers[0].path.name}: {len(events)} "
        f"records, every CRC checked; train_loss_step at steps {step_events}; tags {tags}")
    if step_events != list(range(1, OPTIONS_MICRO_STEPS + 1)) or "explanations" not in tags:
        raise AssertionError("the TensorBoard event file lacks its records")
    with np.load(exp.save_dir / "explanations" / "epoch_0.npz") as f:
        shapes = {k: f[k].shape for k in f.files}
        finite = all(np.isfinite(f[k]).all() for k in f.files)
    png = exp.save_dir / "explanations" / "epoch_0.png"
    trace = root / "profile" / "trace.json"
    trace_kernels = sum(1 for e in json.loads(trace.read_text())["traceEvents"]
                        if e.get("cat") == "kernel")
    hash_line = f"params hash: {param_hash(state.model)}"
    say(f"options 6d: explanations/epoch_0.npz {shapes} (finite: {finite}), epoch_0.png "
        f"{png.stat().st_size} bytes; the profiler trace of step 3, "
        f"{trace.stat().st_size / 1e6:.1f} MB, holds {trace_kernels} CUDA kernel events; "
        f"--debug printed '{hash_line}': {hash_line in printed}")
    if (shapes.get("explanation") != (8, SIZE, SIZE, 4) or not finite or not png.exists()
            or trace_kernels == 0 or hash_line not in printed):
        raise AssertionError("the logging flags did not write what they ask for")

    step = steps_lib.make_train_step(UniformOffLabelsBCEWithLogitsLoss(), 1e-4, use_agc=True,
                                     accumulate=OPTIONS_ACCUM, amp=True)
    weight = state.model.model.layer1_0.conv1.weight
    before = weight.detach().clone()
    reset_launch_counts()
    step(state, batch)
    torch.cuda.synchronize()
    unchanged = torch.equal(weight, before)
    step(state, batch)
    torch.cuda.synchronize()
    per_update = launch_counts()
    changed = not torch.equal(weight, before)
    say(f"options 6b: launches per optimizer step of {OPTIONS_ACCUM} micro-batches "
        f"{per_update}; the parameters unchanged after the first micro-batch: {unchanged}, "
        f"changed after the second: {changed}")
    check_counts("accumulated optimizer step", per_update,
                 scaled_counts(TRAIN_STEP_COUNTS, OPTIONS_ACCUM))
    if not (unchanged and changed):
        raise AssertionError("the accumulated step does not update once per 2 micro-batches")

    def update():
        for _ in range(OPTIONS_ACCUM):
            step(state, batch)

    ms, busy = call_window(update, OPTIONS_WINDOW, f"options 6b: one optimizer step of "
                           f"{OPTIONS_ACCUM} micro-batches of {TRAIN_BATCH} (bf16 amp)")
    say(f"options 6b: {OPTIONS_ACCUM * TRAIN_BATCH / ms * 1e3:.1f} img/s accumulated [{CARD}]")
    val, bound = accumulation_parity()
    say(f"options 6b parity, small flagship fp32, Adam's first moment after one accumulated "
        f"update, gpu vs cpu: {val:.3e} (bound {bound:.3e}: ten CPU spreads)")
    if not val <= bound:
        raise AssertionError("the accumulated step on the GPU disagrees with the CPU")
    return {"k3_per_update": per_update["bcos_matmul_fwd"], "update_ms": ms,
            "img_s": OPTIONS_ACCUM * TRAIN_BATCH / ms * 1e3, "busy_ms": busy}


def options_learnable_b(calibrated, root):
    """6c: Trainer.fit of each learnable-b variant (3 steps at batch 64,
    bf16 amp) with no launch of K1, K2 or K3, then its module-path
    explanation of 8 images (the fast pass refuses the net), the b of the
    stem conv after each step (linear_b: the schedule's closed form in f32,
    exactly) and the step's time."""
    from bcosification_tpu_torch.explain.core import make_explain_fn
    from bcosification_tpu_torch.training import trainer as trainer_lib

    batch = options_batch(SEED + 71)
    out = {}
    for name, bargs in B_VARIANTS.items():
        net, config = options_net(bargs, calibrated)
        exp = options_experiment(root / name.replace(" ", ""), config, ema=False,
                                 b_optimizer=OptimizerFactory("sgd", 0.05))
        trainer = Trainer(exp, {"amp": True})
        t0 = time.perf_counter()
        reset_launch_counts()
        state, _ = fit_printing(trainer, net, RepeatedBatch(batch, OPTIONS_B_STEPS))
        counts = launch_counts()
        fit_s = time.perf_counter() - t0
        check_counts(f"{name} Trainer.fit", counts, NO_KERNEL_COUNTS)
        if fast_resnet.supports(state.model):
            raise AssertionError(f"{name}: the fast pass takes a learnable-b net")
        res, counts_e = counted(lambda: make_explain_fn(state.model)(batch["image"][:8]))
        check_counts(f"{name} explanation", counts_e, NO_KERNEL_COUNTS)
        if not torch.isfinite(res["dynamic_linear_weights"]).all():
            raise AssertionError(f"{name}: the explanation is not finite")

        _, _, schedule = trainer_lib._make_optimizers(exp.config, OPTIONS_B_STEPS)
        b_schedule = trainer_lib._b_schedule(exp.config, TRAIN_BATCH, OPTIONS_B_STEPS)
        step = steps_lib.make_train_step(exp.config["criterion"], schedule, use_agc=True,
                                         b_schedule=b_schedule, amp=True)
        b_param = state.model.model.conv1.b
        trajectory = [b_param.item()]
        reset_launch_counts()
        for _ in range(OPTIONS_WINDOW):
            step(state, batch)
            trajectory.append(b_param.item())
        check_counts(f"{name} steps", launch_counts(), NO_KERNEL_COUNTS)
        exact = None
        if b_schedule is not None:
            want = [np.float32(b_schedule(s)) for s in range(OPTIONS_B_STEPS,
                                                               state.step + 1)]
            exact = [np.float32(v) for v in trajectory] == want
        say(f"options 6c {name}: Trainer.fit of {OPTIONS_B_STEPS} steps {fit_s:.1f} s, "
            f"launches {counts}; explanation (module path) launches {counts_e}; the stem's "
            f"b parameter after steps {OPTIONS_B_STEPS}..{state.step}: "
            + ", ".join(f"{v:.9g}" for v in trajectory)
            + ("" if exact is None else f"; equal to make_linear_b_schedule in f32: {exact}"))
        if exact is False or not all(math.isfinite(v) for v in trajectory):
            raise AssertionError(f"{name}: the b trajectory is off")
        if name == "clamping + manual_optim" and (state.b_optimizer is None
                                                  or b_param.grad is None):
            raise AssertionError("manual_optim did not train b")
        ms, busy = call_window(lambda: step(state, batch), OPTIONS_WINDOW,
                               f"options 6c {name}: one step of {TRAIN_BATCH} (bf16 amp)")
        out[name] = {"ms": ms, "busy_ms": busy, "img_s": TRAIN_BATCH / ms * 1e3}
        del net, state, trainer
    return out


def options_clip_normalisation(calibrated, x2):
    """6f: the bcosified ResNet-50 with bcosify_args.clip_kd (CLIP's
    Normalize constants) in fp32 on 2 images: the card's pre-logits against
    the CPU's within phase 4's 1e-4 (max relative), the argmax identical."""
    from bcosification_tpu_torch.models.bcosify_net import CLIP_MEAN_ADDINVERSE

    net, _ = options_net({"clip_kd": True}, calibrated)
    if net.mean != CLIP_MEAN_ADDINVERSE:
        raise AssertionError(f"clip_kd: Normalize mean {net.mean}")
    with torch.no_grad():
        out = net(x2).double().cpu()
        cpu = copy.deepcopy(net).to("cpu")
        out_c = cpu(x2.cpu()).double()
    bias = net.logit_bias
    err = float(((out - bias) - (out_c - bias)).abs().max() / (out_c - bias).abs().max())
    same = bool(torch.equal(out.argmax(1), out_c.argmax(1)))
    say(f"options 6f: clip_kd ResNet-50 (Normalize mean {net.mean[:3]}...), fp32 pre-logits "
        f"gpu vs cpu {err:.3e} (bound 1e-4, max relative); argmax identical {same}")
    if not err <= 1e-4 or not same or not torch.isfinite(out).all():
        raise AssertionError("the clip_kd net on the GPU disagrees with the CPU")


EXPLAIN_LOG_IMAGES = 8  # Trainer._log_explanations' n_images


def phase_train_options(net, x2, stream_rate, worst):
    """Phase 19: the training options no grid config sets (ROADMAP A5 6b,
    6c, 6d, 6f) on the recipe's bcosified ResNet-50 at full width, from the
    weights of phase 4's calibrated ``net``; then K1, K2 and K3 in fp32 at
    every shape of one explanation logger call (EXPLAIN_LOG_IMAGES images
    of 224^2 through fast_resnet: 36 / 37 / 1 launches; ``fp32_rows``).
    Returns the kernels line's keys of that call."""
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        accumulated = options_accumulation(net, root)
        seconds["6b+6d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        learnable = options_learnable_b(net, root)
        seconds["6c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    options_clip_normalisation(net, x2)
    seconds["6f"] = time.perf_counter() - t0
    say("training options seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    say(f"training options summary: accumulated optimizer step ({OPTIONS_ACCUM} x "
        f"{TRAIN_BATCH}) {accumulated['update_ms']:.2f} ms, {accumulated['img_s']:.1f} img/s, "
        f"K3 {accumulated['k3_per_update']} per optimizer step; learnable-b steps "
        + ", ".join(f"{k} {v['ms']:.2f} ms ({v['img_s']:.1f} img/s)"
                    for k, v in learnable.items()) + f" [{CARD}]")
    per_shape = collections.Counter(main_path_launches(net.model, EXPLAIN_LOG_IMAGES, SIZE))
    return fp32_keys("explanation_logger_fp32", fp32_rows(
        "explanation logger call", per_shape, stream_rate, worst, SEED + 66))


# --------------------------------------------------------------------------
# 20: the CLIP ViT towers
# --------------------------------------------------------------------------
CLIP_VIT_NAME = "vit_b_16_clip_b2_noBias_randomResizedCrop_sigLip_ImageNet_bcosification"
CLIP_VIT_EXPERIMENTS = {"pooled": ("ImageNet", "clip_bcosification", CLIP_VIT_NAME),
                        "unpool": ("ImageNet", "clip_bcosification",
                                   CLIP_VIT_NAME + "_attnUnpool")}
CLIP_VIT_LINEARS = 36  # the B-cos out_proj, c_fc and c_proj of the 12 blocks
CLIP_VIT_EXPORT_DEPTH = 2  # the export round trip runs at a cut depth (export time)
CLIP_VIT_KD_STEPS = 5


def clip_vit_launches(net, batch, explain):
    """[(kernel, M, K, N, relu, eps_outside)] of one encode (K3 at each B-cos
    linear, the linear norm) or one text explanation (and K2 at each, the
    bare cotangent) of a CLIP ViT student: M = batch x (patches + 1)."""
    m = net.model
    rows = batch * ((m.input_resolution // m.patch_size) ** 2 + 1)
    out = []
    for blk in m.blocks():
        for lin in (blk.attn_out_proj, blk.mlp_c_fc, blk.mlp_c_proj):
            k, n = lin.weight.shape
            out.append(("bcos_matmul_fwd", rows, k, n, False, True))
            if explain:
                out.append(("bcos_conv1x1_bwd_explain", rows, k, n, False, True))
    return out


def check_clip_vit_kernels(net, worst):
    """K3 and K2 against their plain versions at every distinct shape of one
    encode at batch 128 (M = 25 216) and of one KD step at batch 64 (M =
    12 608, not a multiple of 128), both dtypes, phase 3's bounds, as the
    tower calls them: the linear norm (eps_outside), K2 with the bare
    cotangent."""
    shapes = sorted({key[1:4] for batch in (BATCH, KD_BATCH)
                     for key in clip_vit_launches(net, batch, False)})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    kw = dict(eps=LINEAR_NORM_EPS, eps_outside=True)
    for dtype in (torch.float32, torch.bfloat16):
        ref = (lambda t: t.float()) if dtype == torch.bfloat16 else (lambda t: t)
        for m, k, n in shapes:
            x, wt, _, _, ct = operands(m, k, n, dtype, gen)
            results = [
                ("bcos_matmul_fwd", k3.bcos_matmul_fwd(x, wt, **kw),
                 k3.bcos_matmul_fwd_plain(ref(x), ref(wt), **kw)),
                ("bcos_conv1x1_bwd_explain",
                 k12.conv1x1_bwd_explain(x, wt, ct, None, None, relu=False, **kw),
                 k12.conv1x1_bwd_explain_plain(ref(x), ref(wt), ref(ct), None, None,
                                               relu=False, **kw)),
            ]
            torch.cuda.synchronize()
            for name, got, want in results:
                _check(worst, name, " eps_outside", f"clip vit M={m} K={k} N={n}", dtype, got,
                       want)
            del x, wt, ct, results
    return len(shapes)


def clip_vit_parity(net, x2, head):
    """fp32, 2 images, GPU against CPU: the features of the module forward,
    W of the text explanation from the fast pass (explain/fast_clip_vit.py)
    and from the module path (autograd through text_score_head), and the two
    paths against each other on the GPU; each within ten times the CPU's own
    spread of that quantity under 1e-7 relative input noise, the patchify
    conv on PyTorch's own CUDA conv (cuDNN's fp32 convs are held to phase
    4's 1e-3, as phase 10 holds them). Returns the text direction."""
    from bcosification_tpu_torch.explain import fast_clip_vit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = x2.device
    t = _text_direction(net.model.proj.shape[1], SEED + 72, dev)

    def passes(model, x, device):
        with torch.no_grad():
            feats = model(x)
        scores, w = fast_clip_vit.fast_text_dlw(model, x, t.to(device), device=device)
        xx = x.clone().requires_grad_(True)
        sm = fast_clip.text_score_head(model(xx, explain=True), t.to(device))
        (wm,) = torch.autograd.grad(sm.sum(), xx)
        return feats, scores, w, wm

    _, _, w_cudnn, _ = passes(net, x2, dev)
    torch.backends.cudnn.enabled = False
    try:
        fg, sg, wg, wmg = passes(net, x2, dev)
    finally:
        torch.backends.cudnn.enabled = True
    cpu = copy.deepcopy(net).to("cpu")
    t0 = time.perf_counter()
    fc, sc, wc, wmc = passes(cpu, x2.cpu(), "cpu")
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 73))
    fn, _, wn, wmn = passes(cpu, x2.cpu() * (1 + 1e-7 * noise), "cpu")
    cpu_s = time.perf_counter() - t0
    spreads = {"features": rel(fn, fc), "W fast": rel(wn, wc), "W module": rel(wmn, wmc)}
    checks = {
        "features gpu vs cpu": (rel(fg, fc), 10 * spreads["features"]),
        "W fast pass gpu vs cpu": (rel(wg, wc), 10 * spreads["W fast"]),
        "W module path gpu vs cpu": (rel(wmg, wmc), 10 * spreads["W module"]),
        "W module path vs fast pass (gpu)": (rel(wmg, wg), 10 * spreads["W fast"]),
        "W fast pass gpu (cudnn conv) vs cpu": (rel(w_cudnn, wc), 1e-3),
    }
    rms = float(fc.double().pow(2).mean().sqrt())
    say(f"clip vit {head} parity: feature RMS {rms:.4g}, |W| max {float(wc.abs().max()):.3e}, "
        f"scores {sc.tolist()}; the CPU's spreads under 1e-7 relative input noise: "
        + ", ".join(f"{k} {v:.3e}" for k, v in spreads.items())
        + f"; the CPU passes took {cpu_s:.1f} s")
    for key, (val, bound) in checks.items():
        say(f"clip vit {head} parity {key}: {val:.3e} (bound {bound:.3e})")
    if not rms > 1e-3 or not float(wc.abs().max()) > 0:
        raise AssertionError(f"CLIP ViT {head}: vacuous features or W")
    if any(not val <= bound for val, bound in checks.values()):
        raise AssertionError(f"CLIP ViT {head} parity failed")
    if not all(torch.isfinite(v).all() for v in (fg, sg, wg)) or wg.shape != x2.shape:
        raise AssertionError(f"CLIP ViT {head} outputs are not finite or mis-shaped")
    return t


def linear_input_dtypes(net, fn):
    """{dtype: calls} of the inputs that reach the tower's B-cos linears in
    fn() (the module path)."""
    seen = collections.Counter()
    hooks = [lin.register_forward_pre_hook(lambda mod, args: seen.update([str(args[0].dtype)[6:]]))
             for blk in net.model.blocks()
             for lin in (blk.attn_out_proj, blk.mlp_c_fc, blk.mlp_c_proj)]
    try:
        with torch.no_grad():
            fn()
    finally:
        for hook in hooks:
            hook.remove()
    return dict(seen)


def clip_vit_throughput(net, x, t, head):
    """Encode and text fwd+explain (the fast pass) images/s at batch 128,
    bf16 images, each with its launch counts (K3 36 per encode; K3 36 and
    K2 36 per explanation; no K1), host issue time, peak memory, the card's
    busy time and top kernels."""
    from bcosification_tpu_torch.explain import fast_clip_vit

    def encode():
        with torch.no_grad():
            return net(x)

    def text_explain():
        return fast_clip_vit.fast_text_dlw(net, x, t, device=x.device)

    out = {}
    for what, fn, explain_ in (("encode", encode, False), ("text fwd+explain", text_explain,
                                                           True)):
        result, counts = counted(fn)
        check_counts(f"clip vit {head} {what}", counts,
                     kernel_counts(clip_vit_launches(net, 1, explain_)))
        outs = result if isinstance(result, tuple) else (result,)
        if not all(torch.isfinite(v).all() for v in outs):
            raise AssertionError(f"CLIP ViT {head} {what}: outputs are not finite")
        del result, outs
        ms, calls, host, peak_gb = windowed(fn)
        busy, top = device_profile(fn, 3)
        say(f"clip vit {head} throughput {what}: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per "
            f"batch of {BATCH}, one window of {calls} calls; the host issues one call in "
            f"{host:.2f} ms; peak memory of one call {peak_gb:.2f} GB; launches {counts}) "
            f"[{CARD}]")
        say(f"clip vit {head} {what}: card busy {busy or 0:.2f} ms per call (torch.profiler); "
            "top kernels: " + "; ".join(f"{name[:60]} {kms:.2f} ms" for name, kms in top))
        out[what] = {"img_s": BATCH / ms * 1e3, "ms": ms, "host_ms": host, "peak_gb": peak_gb,
                     "busy_ms": busy}
    return out


def clip_vit_serving(x2, t):
    """export_text_explain of the unpooled student at CLIP_VIT_EXPORT_DEPTH
    blocks (full width, random init from SEED), loaded from bytes: at batch
    128, bf16, its scores and W equal to the eager pass's (1e-6 relative),
    the launches identical. Returns the export seconds."""
    from bcosification_tpu_torch.bcosify.clip_import import build_bcosified_clip_vit_visual
    from bcosification_tpu_torch.clip.model import clip_vit_config
    from bcosification_tpu_torch.explain import fast_clip_vit

    exp = Experiment(*CLIP_VIT_EXPERIMENTS["unpool"])
    cfg = {**clip_vit_config("ViT-B/16"), "vision_layers": CLIP_VIT_EXPORT_DEPTH}
    net = build_bcosified_clip_vit_visual(exp.model_config, None, cfg, seed=SEED)
    t0 = time.perf_counter()
    program = serving.load_serialized(serving.export_text_explain(
        net, embed_dim=t.shape[0], input_size=SIZE, dtype=torch.bfloat16))
    export_s = time.perf_counter() - t0
    x, t16 = _batch128(x2, SEED + 74), t.to(torch.bfloat16)
    (s, w), counts = counted(lambda: program.call(x, t16))
    (es, ew), counts_e = counted(lambda: fast_clip_vit.fast_text_dlw(net, x, t16))
    checks = {"scores loaded vs eager (rel)": (rel(s.float(), es.float()), 1e-6),
              "W loaded vs eager (rel)": (rel(w.float(), ew.float()), 1e-6)}
    say(f"clip vit serving (depth {CLIP_VIT_EXPORT_DEPTH}, attn-unpool): export_text_explain "
        f"and load {export_s:.1f} s; launches {counts} (eager {counts_e}); " + ", ".join(
            f"{key} {val:.3e} (bound {bound:.0e})" for key, (val, bound) in checks.items()))
    if counts != counts_e or any(not val <= bound for val, bound in checks.values()):
        raise AssertionError("the loaded CLIP ViT program disagrees with the eager pass")
    return export_s


def clip_vit_kd(net, x2):
    """Trainer.fit of the attn-unpool ViT-B/16 KD Experiment (-> fit_kd; the
    ViT-B/16 teacher of clip/load.py at random init) for CLIP_VIT_KD_STEPS
    steps on one repeated batch of 64, bf16 amp: finite losses, K3 36 per
    step (and per validation batch), the teacher unchanged, the student
    moved; then the step's ms and img/s over a window (``kd_window``)."""
    exp = Experiment(*CLIP_VIT_EXPERIMENTS["unpool"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 75)
    images = torch.rand((KD_BATCH, SIZE, SIZE, 3), device="cuda", generator=gen)
    images[:2] = x2[:, :, :, :3]
    batch = {"image": images}
    per_step = kernel_counts(clip_vit_launches(net, 1, False))
    before = param_hash(net)
    with without_zeroshot(), recorded_kd() as rec:
        t0 = time.perf_counter()
        trainer = Trainer(exp, {"amp": True})
        state, counts = counted(lambda: trainer.fit(net, RepeatedBatch(batch, CLIP_VIT_KD_STEPS),
                                                    max_epochs=1))
        fit_s = time.perf_counter() - t0
    teacher = rec.teachers[0]
    losses = [float(v) for v in rec.losses]
    fresh = importlib.import_module("bcosification_tpu_torch.clip.load").load("ViT-B/16")[0]
    frozen = param_hash(teacher) == param_hash(fresh)
    moved = param_hash(state.model) != before
    say(f"clip vit kd Trainer.fit (-> fit_kd) of {CLIP_VIT_KD_STEPS} steps at batch {KD_BATCH}, "
        f"bf16 amp: {fit_s:.1f} s; launches {counts}; losses {losses}; the teacher equal to a "
        f"fresh load: {frozen}; the student moved: {moved}")
    check_counts("clip vit kd Trainer.fit", counts,
                 scaled_counts(per_step, CLIP_VIT_KD_STEPS + 1))  # + one val batch
    if (len(losses) != CLIP_VIT_KD_STEPS or not all(math.isfinite(v) for v in losses)
            or not frozen or not moved or state.step != CLIP_VIT_KD_STEPS):
        raise AssertionError(f"clip vit kd: losses {losses}, teacher frozen {frozen}, student "
                             f"moved {moved}, steps {state.step}")
    del fresh, state
    return kd_window("clip vit unpool", net, teacher, batch, counts=per_step)


def phase_clip_vit(x2, stream_rate, worst):
    """Phase 20: the B-cosified CLIP ViT-B/16 students of the clip_bcosification
    recipe (pooled and attn-unpool; width 768, 12 blocks, 12 heads, patch 16,
    197 tokens, embed_dim 512; random init from SEED, no calibration: the
    pre-norm LayerNorms keep every block's input at unit scale). Returns the
    CLIP ViT keys of K2's and K3's rows of the kernels line."""
    nets = {head: Experiment(*experiment).get_model()
            for head, experiment in CLIP_VIT_EXPERIMENTS.items()}
    for head, net in nets.items():
        n = kernel_counts(clip_vit_launches(net, 1, True))
        if n["bcos_matmul_fwd"] != CLIP_VIT_LINEARS or n["bcos_conv1x1_bwd_explain"] != (
                CLIP_VIT_LINEARS):
            raise AssertionError(f"clip vit {head}: {n}, expected {CLIP_VIT_LINEARS} B-cos "
                                 "linears")
    n_shapes = check_clip_vit_kernels(nets["pooled"], worst)
    say(f"clip vit: K3 and K2 checked at the {n_shapes} distinct shapes of one encode at batch "
        f"{BATCH} and one KD step at batch {KD_BATCH}, both dtypes")
    ts = {head: clip_vit_parity(net, x2, head) for head, net in nets.items()}
    # the per-token head's rates (text localisation's and the KD config's
    # tower); the pooled head differs only in its last ln_post and proj
    rates = clip_vit_throughput(nets["unpool"], _batch128(x2, SEED + 76), ts["unpool"],
                                "unpool")
    export_s = clip_vit_serving(x2, ts["unpool"])
    kd = clip_vit_kd(nets["unpool"], x2)
    unpool = nets["unpool"]
    # the q/k/v projection's bias (zeroed, not removed) promotes the residual
    # stream to f32 after the first block's attention, as in the JAX package:
    # the kernels are timed in the dtype that reaches them on the path
    dtypes = linear_input_dtypes(unpool, lambda: unpool(_batch128(x2, SEED + 76)))
    dtype = torch.float32 if set(dtypes) == {"float32"} else torch.bfloat16
    say(f"clip vit: the dtypes that reach the B-cos linears of a bf16 encode: {dtypes}; the "
        f"kernels are timed in {str(dtype)[6:]}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 77)
    rows = {what: time_shapes(collections.Counter(clip_vit_launches(unpool, batch, explain_)),
                              stream_rate, gen, tag=f"clip vit {what} ", dtype=dtype)
            for what, batch, explain_ in (("encode", BATCH, False), ("explain", BATCH, True),
                                          ("kd", KD_BATCH, False))}
    say(f"clip vit summary: attn-unpool encode {rates['encode']['img_s']:.1f} img/s, text "
        f"fwd+explain {rates['text fwd+explain']['img_s']:.1f}; KD step {kd['img_s']:.1f} img/s "
        f"({kd['ms']:.2f} ms); export at depth {CLIP_VIT_EXPORT_DEPTH} {export_s:.1f} s [{CARD}]")
    keys = {}
    for what, explain_ in (("encode", False), ("explain", True), ("kd", False)):
        counts = kernel_counts(clip_vit_launches(unpool, 1, explain_))
        per = "KD step (batch 64)" if what == "kd" else what
        for name, r in rows[what].items():
            side = (f"3xTF32 at 495 TFLOP/s; {fp32_cores_ms(r):.4f} ms at 67 TFLOP/s fp32"
                    if dtype == torch.float32 else "bf16")
            say(f"clip vit {name} per ViT-B/16 {per} ({counts[name]} launches): {r['ms']:.4f} "
                f"ms; bound {1e3 * r['bound_s']:.4f} ms at the data-sheet rate, "
                f"{1e3 * r['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} "
                f"GB/s ({side}); plain {r['plain_ms']:.4f} ms, torch.matmul "
                f"{r['library_ms']:.4f} ms [{CARD}]")
            keys.setdefault(name, {}).update({
                f"clip_vit_{what}_launches": counts[name], f"clip_vit_{what}_ms": r["ms"],
                f"clip_vit_{what}_dtype": str(dtype)[6:],
                f"clip_vit_{what}_bound_ms": 1e3 * r["bound_s"],
                f"clip_vit_{what}_plain_ms": r["plain_ms"],
                f"clip_vit_{what}_library_ms": r["library_ms"]})
            if dtype == torch.float32:
                keys[name][f"clip_vit_{what}_bound_fp32_cores_ms"] = fp32_cores_ms(r)
    keys["bcos_matmul_fwd"].update({"clip_vit_kd_step_ms": kd["ms"],
                                    "clip_vit_kd_step_img_s": kd["img_s"]})
    return keys


# --------------------------------------------------------------------------
# 21: the switch-MoE ViT (ROADMAP A7) and dynamic-int8 serving (A8)
# --------------------------------------------------------------------------
MOE_EXPERTS, MOE_CAPACITY, MOE_TOP_KS = 8, 1.25, (1, 2)
MOE_EXPORT_DEPTH = 1  # the MoE ViT's export round trip at a cut depth (export time)
# the int8 export round trip: ResNet-50 cut to its first two stages, one
# bottleneck each (layer1 on K1, layer2 and the classifier quantized)
INT8_EXPORT_LAYERS = ("bottleneck", (1, 1))
# int8 against bf16 pre-logits (rel L2): the quantization's own error, not
# parity; the JAX package measured ~7 % with every conv quantized
INT8_PRELOGIT_BOUND = 0.25
INT8_TOPS = 1979e12  # H100 SXM dense int8 (NVIDIA data sheet)


def moe_vit(depth=12):
    """ViT-B/16 (BcosLinear, the default SimpleViT layers, 6 channels) with
    MOE_EXPERTS experts in every feed-forward, on the card, random init from
    SEED."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    return vit_models.simple_vit_b_patch16_224(
        depth=depth, moe_experts=MOE_EXPERTS, moe_capacity_factor=MOE_CAPACITY, device="cuda",
        generator=gen)


def set_top_k(net, k):
    """Route every BcosMoE of ``net`` to its top ``k`` (the same weights)."""
    for mod in net.modules():
        if isinstance(mod, BcosMoE):
            mod.top_k = k


@contextlib.contextmanager
def imposed_routing(net, choices, stats):
    """Every BcosMoE of ``net`` takes the experts ``choices`` {module name:
    top_idx [N, k]} gives it (its gates from its own probabilities at those
    experts), as ``shared_gates`` imposes one device's ReLU gates on the
    other. Per call, ``stats`` gets (the decisions that differ from its own,
    the largest probability by which an imposed choice trails its own)."""
    moes = [(name, mod) for name, mod in net.named_modules() if isinstance(mod, BcosMoE)]

    def impose(name, mod):
        def choose(probs):
            _, own = BcosMoE.choose(mod, probs)
            idx = choices[name].to(probs.device)
            gates = probs.gather(1, idx)
            if mod.top_k > 1 and mod.renormalize_gates:
                gates = gates / gates.sum(-1, keepdim=True)
            margin = (probs.gather(1, own) - probs.gather(1, idx)).max()
            stats.append((int((own != idx).sum()), float(margin.detach())))
            return gates, idx
        return choose

    for name, mod in moes:
        mod.choose = impose(name, mod)
    try:
        yield
    finally:
        for _, mod in moes:
            del mod.choose


def moe_parity(net, x2, k):
    """fp32, 2 images, top-k routing: the fast pass on the CPU records its
    choices; the fast pass and the module path on the GPU, and the CPU under
    1e-7 relative input noise, run under them. W within ten times the CPU's
    spread under that noise, the pre-logits within 1e-4, the argmax
    identical; the decisions the GPU would have made otherwise, and their
    largest probability margin, within ten times the CPU's spread of the
    router's probabilities under the noise. Then x . W = the selected logit
    without the positional embedding (every other constant, the
    LayerNorms' biases, is 0 at init)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_top_k(net, k)
    cpu = copy.deepcopy(net).to("cpu")
    key = "top_idx" if k > 1 else "expert_idx"
    t0 = time.perf_counter()
    with record_intermediates(cpu) as rec:
        lc, sc, wc = fast_vit.fast_dynamic_linear_weights(cpu, x2.cpu(), device="cpu")
    choices = {name: r[key][0] if k > 1 else r[key][0][:, None] for name, r in rec.items()}
    noise = torch.randn(x2.shape, generator=torch.Generator().manual_seed(SEED + 81))
    cpu_stats = []
    with record_intermediates(cpu) as rec_n, imposed_routing(cpu, choices, cpu_stats):
        ln, _, wn = fast_vit.fast_dynamic_linear_weights(cpu, x2.cpu() * (1 + 1e-7 * noise),
                                                         device="cpu")
    cpu_s = time.perf_counter() - t0
    p_spread = max(float((rec_n[name]["router_probs"][0] - r["router_probs"][0]).abs().max())
                   for name, r in rec.items())
    stats = []
    with imposed_routing(net, choices, stats):
        lg, sg, wg = fast_vit.fast_dynamic_linear_weights(net, x2)
        lm, sm, wm = dynamic_linear_weights(lambda t: net(t, explain=True), x2)
    spread = rel(wn, wc)
    flips = sum(n for n, _ in stats)
    margin = max((m for n, m in stats if n), default=0.0)

    def pre_rel(a, b):
        a, b = a.double().cpu(), b.double().cpu()
        return float((a - b).abs().max() / b.abs().max())

    net.pos_embedding = False
    try:
        lp, sp, wp = fast_vit.fast_dynamic_linear_weights(net, x2)
    finally:
        net.pos_embedding = True
    complete = float(((x2 * wp).sum((1, 2, 3)) - lp.gather(1, sp[:, None])[:, 0]).abs().max()
                     / lp.abs().max())
    checks = {
        "W fast pass gpu vs cpu": (rel(wg, wc), 10 * spread),
        "W module path gpu vs cpu": (rel(wm, wc), 10 * spread),
        "W module path vs fast pass (gpu)": (rel(wm, wg), 10 * spread),
        "pre-logit fast pass gpu vs cpu (max rel)": (pre_rel(lg, lc), 1e-4),
        "pre-logit module path vs fast pass (gpu, max rel)": (pre_rel(lm, lg), 1e-4),
        "routing margin of the differing decisions": (margin, 10 * p_spread),
        "x . W - logit without the positional embedding (max rel)": (complete, 1e-4),
    }
    say(f"moe top-{k} parity: {flips} of {sum(c.numel() for c in choices.values())} top-{k} "
        f"decisions on the GPU differ from the CPU's (imposed); the router's probabilities "
        f"move {p_spread:.3e} on the cpu under 1e-7 relative input noise (decisions that "
        f"differ there: {sum(n for n, _ in cpu_stats)}); W on the cpu under that noise: "
        f"{spread:.3e}; the two CPU passes took {cpu_s:.1f} s")
    for name, (val, bound) in checks.items():
        say(f"moe top-{k} parity {name}: {val:.3e} (bound {bound:.3e})")
    same_sel = bool((sg.cpu() == sc).all() and (sm == sg).all())
    if not same_sel or any(not val <= bound for val, bound in checks.values()):
        raise AssertionError(f"MoE ViT top-{k} parity failed")
    if not all(torch.isfinite(t).all() for t in (lg, wg)) or wg.shape != x2.shape:
        raise AssertionError(f"MoE ViT top-{k} outputs are not finite or mis-shaped")


def phase_moe(x2, stream_rate, worst):
    """Phase 21 (a): the switch-MoE ViT-B/16 (MOE_EXPERTS experts per
    feed-forward, capacity factor MOE_CAPACITY) at top-1 and top-2. Returns
    the MoE keys of K2's and K3's rows of the kernels line."""
    net = moe_vit()
    capacities = {}
    for k in MOE_TOP_KS:
        set_top_k(net, k)
        capacities[k] = net.encoder_0.ff.moe2.capacity(VIT_ROWS)
    moe = net.encoder_0.ff.moe2
    check_vit_kernels(worst, [(f"moe expert top-{k}", c, moe.in_features, moe.features)
                              for k, c in capacities.items()])
    x = _batch128(x2, SEED + 83)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 84)
    keys, rates = {}, {}
    for k in MOE_TOP_KS:
        moe_parity(net, x2, k)
        rates[k] = vit_rates(net, [
            ("forward-only", vit_forward(net, x), False),
            ("fwd+explain (fast pass)", lambda: fast_vit.fast_dynamic_linear_weights(net, x),
             True)], f"moe top-{k}")
        counts = vit_counts(net, True)
        rows = time_shapes(collections.Counter(vit_launches(net, BATCH, SIZE, True)),
                           stream_rate, gen, tag=f"moe top-{k} ")
        for name, r in rows.items():
            what = "explanation" if name == "bcos_conv1x1_bwd_explain" else "forward"
            say(f"moe {name} per MoE ViT-B/16 top-{k} {what} ({counts[name]} launches, "
                f"{MOE_EXPERTS} per MoE of {capacities[k]} slots): {r['ms']:.4f} ms; bound "
                f"{1e3 * r['bound_s']:.4f} ms at the data-sheet rate "
                f"({'FLOPs' if r['flop_s'] >= r['byte_s'] else 'bytes'}), "
                f"{1e3 * r['measured_bound_s']:.4f} ms at the measured "
                f"{stream_rate / 1e9:.1f} GB/s; plain {r['plain_ms']:.4f} ms, torch.matmul "
                f"{r['library_ms']:.4f} ms [{CARD}]")
            keys.setdefault(name, {}).update({
                f"moe_top{k}_launches": counts[name], f"moe_top{k}_ms": r["ms"],
                f"moe_top{k}_bound_ms": 1e3 * r["bound_s"],
                f"moe_top{k}_plain_ms": r["plain_ms"], f"moe_top{k}_library_ms": r["library_ms"]})
    del x
    shallow = moe_vit(MOE_EXPORT_DEPTH)
    set_top_k(shallow, 2)
    served = vit_serving(shallow, _batch128(x2, SEED + 85),
                         tag=f"moe top-2 depth {MOE_EXPORT_DEPTH}")
    del shallow
    batch = _images(VIT_TRAIN_BATCH, SEED + 86)
    train = vit_train_window("moe top-2 vit-b/16", net, Experiment(
        *VIT_EXPERIMENTS["default"]).config, batch, len(vit_launches(net, 1, SIZE, False)))
    del batch, net
    say(f"moe summary: " + "; ".join(
        f"top-{k} forward-only {r['forward-only']['img_s']:.1f} img/s, fwd+explain (fast pass) "
        f"{r['fwd+explain (fast pass)']['img_s']:.1f}" for k, r in rates.items())
        + f"; top-2 train step {train['img_s']:.1f} img/s (batch {VIT_TRAIN_BATCH}); export at "
        f"depth {MOE_EXPORT_DEPTH}: export_forward "
        f"{served['export_seconds']['export_forward']:.1f} s, export_explain "
        f"{served['export_seconds']['export_explain']:.1f} s [{CARD}]")
    return keys


@contextlib.contextmanager
def int8_serving():
    """BCOS_INT8=1 at the default BCOS_INT8_MIN_CH for the block; the
    environment as it was after it, so no later phase runs quantized."""
    saved = {key: os.environ.get(key) for key in ("BCOS_INT8", "BCOS_INT8_MIN_CH")}
    os.environ["BCOS_INT8"] = "1"
    os.environ.pop("BCOS_INT8_MIN_CH", None)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def int8_convs(model):
    """The convs of ``model`` that BCOS_INT8 quantizes at the default
    BCOS_INT8_MIN_CH (128): both channel counts per group at least 128."""
    return [mod for mod in model.modules() if isinstance(mod, BcosConv2d)
            and min(mod.weight.shape[1], mod.weight.shape[0] // mod.groups) >= 128]


def int8_route_times(model, stream_rate):
    """At every quantized 1x1 of one ResNet-50 forward at batch 128: the int8
    route (``conv_int8_dynamic``: quantize, ``torch._int_mm``, dequantize),
    its ``_int_mm`` alone beside its bound at 1979 TOP/s int8, and the bf16
    kernel it replaces (K1, K3 at the classifier). Returns the sums."""
    convs, (m, k, n) = conv1x1_shapes(model, BATCH, SIZE)
    shapes = collections.Counter((cm, ck, cn, relu, stride) for cm, ck, cn, relu, stride in convs
                                 if min(ck, cn) >= 128)
    shapes[(m, k, n, None, 1)] += 1  # the classifier, on K3 in bf16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 87)
    tot = dict(int8=0.0, int_mm=0.0, int_mm_bound=0.0, replaced=0.0)
    for (cm, ck, cn, relu, stride), count in sorted(shapes.items()):
        side = int(round(math.sqrt(cm / BATCH)))
        x4 = torch.randn(BATCH, side * stride, side * stride, ck, device="cuda",
                         generator=gen).to(torch.bfloat16)
        w = torch.randn(cn, ck, 1, 1, device="cuda", generator=gen) / math.sqrt(ck)
        x2d = x4[:, ::stride, ::stride].reshape(cm, ck).contiguous()
        wt = w.view(cn, ck).to(torch.bfloat16)
        mult, add = torch.rand(cn, device="cuda") + 0.5, torch.randn(cn, device="cuda")
        xq = torch.randint(-127, 128, (cm, ck), device="cuda", generator=gen, dtype=torch.int8)
        wq = torch.randint(-127, 128, (ck, cn), device="cuda", generator=gen, dtype=torch.int8)
        t_int8 = stream_bandwidth.event_ms(lambda: bcos_ops.conv_int8_dynamic(x4, w, stride), 5)
        t_mm = stream_bandwidth.event_ms(lambda: int8_ops.int_mm(xq, wq), 5)
        replaced = (lambda: k3.bcos_matmul_fwd(x2d, wt, eps=1e-6, eps_outside=False)) \
            if relu is None else (lambda: k12.conv1x1_fwd(x2d, wt, mult, add, relu=relu))
        t_rep = stream_bandwidth.event_ms(replaced, 5)
        bound = max(2 * cm * ck * cn / INT8_TOPS, (cm * ck + ck * cn + 4 * cm * cn) / PEAK_BYTES)
        say(f"int8 route M={cm:6d} K={ck:4d} N={cn:4d} stride {stride} x{count:2d}: "
            f"conv_int8_dynamic {t_int8:.4f} ms, _int_mm alone {t_mm:.4f} ms (bound "
            f"{1e3 * bound:.4f} ms), the bf16 {'K3' if relu is None else 'K1'} it replaces "
            f"{t_rep:.4f} ms [{CARD}]")
        tot["int8"] += count * t_int8
        tot["int_mm"] += count * t_mm
        tot["int_mm_bound"] += count * 1e3 * bound
        tot["replaced"] += count * t_rep
        del x4, w, x2d, wt, xq, wq
    say(f"int8 route per ResNet-50 forward ({sum(shapes.values())} quantized 1x1s): "
        f"{tot['int8']:.4f} ms, of it _int_mm {tot['int_mm']:.4f} ms (bound "
        f"{tot['int_mm_bound']:.4f} ms at 1979 TOP/s); the bf16 K1 and K3 launches it replaces "
        f"{tot['replaced']:.4f} ms [{CARD}]")
    return tot


def phase_int8(net, x2, stream_rate):
    """Phase 21 (b): BCOS_INT8=1 serving on phase 4's calibrated ResNet-50
    at full depth, bf16, batch 128. Returns the int8 keys of K1's row of
    the kernels line."""
    x = _batch128(x2, SEED + 88)
    quantized = int8_convs(net.model)
    layer1 = [mod for name, mod in net.model.named_modules()
              if name.startswith("layer1_") and isinstance(mod, BcosConv2d)
              and mod.kernel_size == (1, 1)]

    def forward():
        with torch.no_grad():
            return net(x)

    records, product = [], int8_ops.int8_product

    def recording(xq, wq, *args):
        y = product(xq, wq, *args)
        records.append((xq, wq, args, y))
        return y

    with int8_serving():
        forward()
        int8_ops.int8_product = recording
        try:
            _, counts = counted(forward)
        finally:
            int8_ops.int8_product = product
    products = len(records)
    records.clear()
    say(f"int8 forward launches {counts}; {products} int8 products (torch._int_mm), "
        f"{len(quantized)} convs with at least 128 channels per group on both sides; "
        f"layer1's {len(layer1)} 1x1s stay on K1")
    fc_k3 = int(not any(mod is net.model.fc for mod in quantized))  # 0: the int8 route takes it
    check_counts("int8 forward", counts, {**dict.fromkeys(MODEL_KERNELS, 0),
                                          "bcos_conv1x1_fwd": len(layer1),
                                          "bcos_matmul_fwd": fc_k3, "stream_add": 0})
    if products != len(quantized):
        raise AssertionError(f"int8 forward: {products} products, {len(quantized)} convs")
    rates = {"bf16": [], "int8": []}
    for mode in ("bf16", "int8"):
        with int8_serving() if mode == "int8" else contextlib.nullcontext():
            ms, calls, host, peak_gb = windowed(forward)
            busy, top = device_profile(forward, 3)
        rates[mode].append(BATCH / ms * 1e3)
        say(f"int8 serving {mode} forward-only: {BATCH / ms * 1e3:.1f} img/s ({ms:.2f} ms per "
            f"batch of {BATCH}, one window of {calls} calls; host {host:.2f} ms; peak memory "
            f"{peak_gb:.2f} GB; card busy {busy or 0:.2f} ms per call) [{CARD}]")
        say(f"int8 serving {mode} top kernels: "
            + "; ".join(f"{name[:60]} {t:.2f} ms" for name, t in top))
    # the card's int32 products against the CPU's plain route, one image
    int8_ops.int8_product = recording
    try:
        with int8_serving(), torch.no_grad():
            net(x[:1])
    finally:
        int8_ops.int8_product = product
    t0 = time.perf_counter()
    equal = [torch.equal(int8_ops.int8_product_plain(xq.cpu(), wq.cpu(), *args), y.cpu())
             for xq, wq, args, y in records]
    shapes = {(tuple(xq.shape), tuple(wq.shape), args) for xq, wq, args, _ in records}
    say(f"int8 products of one image on the card (torch._int_mm) against the CPU's plain "
        f"float64 conv: {sum(equal)} of {len(records)} equal ({len(shapes)} distinct shapes; "
        f"{time.perf_counter() - t0:.1f} s)")
    if len(records) != len(quantized) or not all(equal):
        raise AssertionError("the card's int8 products differ from the plain version")
    del records
    net.with_logit_layer = False
    try:
        pre_bf16 = forward().double()
        with int8_serving():
            pre_int8 = forward().double()
    finally:
        net.with_logit_layer = True
    err = rel(pre_int8, pre_bf16)
    agree = float((pre_int8.argmax(1) == pre_bf16.argmax(1)).double().mean())
    say(f"int8 serving pre-logits against bf16: rel L2 {err:.4f} (bound "
        f"{INT8_PRELOGIT_BOUND}); top-1 agreement {agree:.4f} over {BATCH} images")
    if not err <= INT8_PRELOGIT_BOUND or not torch.isfinite(pre_int8).all():
        raise AssertionError("int8 serving pre-logits are off")
    xg = x[:1].clone().requires_grad_()
    with int8_serving():
        try:
            net(xg).float().sum().backward()
        except RuntimeError as err_:
            if "BCOS_INT8" not in str(err_):
                raise
            say("int8 serving: a backward through a quantized conv raises, naming BCOS_INT8")
        else:
            raise AssertionError("a backward through a quantized conv did not raise")
    # the export round trip, BCOS_INT8 baked in at trace time
    shallow = build_bcosified_resnet(FLAGSHIP, seed=SEED, layers=INT8_EXPORT_LAYERS)
    calibrate(shallow, x2[:1])
    with int8_serving():
        t0 = time.perf_counter()
        program = serving.load_serialized(serving.export_forward(
            shallow, input_size=SIZE, dtype=torch.bfloat16))
        export_s = time.perf_counter() - t0
        with torch.no_grad():
            want = shallow(x)
    got, counts_l = counted(lambda: program.call(x))
    with torch.no_grad():
        plain = shallow(x)
    n_int_mm = program.program.graph_module.code.count("aten._int_mm")
    err_l = rel(got.double() - shallow.logit_bias, want.double() - shallow.logit_bias)
    say(f"int8 export_forward at layers {INT8_EXPORT_LAYERS[1]}: export and load {export_s:.1f} "
        f"s; {n_int_mm} _int_mm in the program; loaded (BCOS_INT8 unset) against the eager int8 "
        f"forward {err_l:.3e} (bound 1e-6), against the eager bf16 one "
        f"{rel(got.double(), plain.double()):.3e}; launches {counts_l}")
    if (n_int_mm < len(int8_convs(shallow.model)) or not err_l <= 1e-6
            or torch.equal(got, plain) or not torch.equal(got.argmax(1), want.argmax(1))):
        raise AssertionError("the int8 export round trip failed")
    del shallow, program
    route = int8_route_times(net.model, stream_rate)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 89)
    per = collections.Counter(("bcos_conv1x1_fwd", cm, ck, cn, relu)
                              for cm, ck, cn, relu, _ in conv1x1_shapes(net.model, BATCH, SIZE)[0]
                              if min(ck, cn) < 128)
    r = time_shapes(per, stream_rate, gen, tag="int8 layer1 ")["bcos_conv1x1_fwd"]
    say(f"bcos_conv1x1_fwd per int8 ResNet-50 forward ({len(layer1)} launches: layer1): "
        f"{r['ms']:.4f} ms; bound {1e3 * r['bound_s']:.4f} ms at the data-sheet rate, "
        f"{1e3 * r['measured_bound_s']:.4f} ms at the measured {stream_rate / 1e9:.1f} GB/s; "
        f"plain {r['plain_ms']:.4f} ms, torch.matmul {r['library_ms']:.4f} ms [{CARD}]")
    say(f"int8 summary: forward-only bf16 {', '.join(f'{v:.1f}' for v in rates['bf16'])} img/s, "
        f"int8 {', '.join(f'{v:.1f}' for v in rates['int8'])}; pre-logits rel {err:.4f}, top-1 "
        f"agreement {agree:.4f}; export {export_s:.1f} s [{CARD}]")
    return {"bcos_conv1x1_fwd": {
        "int8_fwd_launches": len(layer1), "int8_fwd_ms": r["ms"],
        "int8_fwd_bound_ms": 1e3 * r["bound_s"], "int8_fwd_plain_ms": r["plain_ms"],
        "int8_fwd_library_ms": r["library_ms"], "int8_route_ms": route["int8"],
        "int8_int_mm_ms": route["int_mm"], "int8_int_mm_bound_ms": route["int_mm_bound"],
        "int8_replaced_bf16_ms": route["replaced"]}}


def phase_moe_int8(net, x2, stream_rate, worst):
    """Phase 21: (a) the switch-MoE ViT-B/16, (b) dynamic-int8 serving of
    the ResNet-50. Returns their keys of the kernels line."""
    keys = phase_moe(x2, stream_rate, worst)
    for name, row in phase_int8(net, x2, stream_rate).items():
        keys.setdefault(name, {}).update(row)
    return keys


def text_localisation_call(student):
    """One fp32 text localisation (``compute_attributions`` of the
    attn-unpool ``student`` on one seeded 224^2 image and text direction,
    the student calibrated on that image): ms per call over 10 calls in a
    row, and the card's busy ms of one call."""
    from bcosification_tpu_torch.interpretability.analyses import text_localisation as tl

    rgb = analysis_images(1, SEED + 41).cuda().float() / 255
    image = torch.cat([rgb, 1.0 - rgb], dim=-1)
    calibrate(student, image)
    emb = _text_direction(student.model.attnpool.c_proj.features, SEED + 42, "cuda")

    def call():
        return tl.compute_attributions(student, emb, image, pool_cosine=2)

    return window_ms(call, 10), device_profile(call, 3)[0]


def fp32_routes() -> int:
    """``chip_smoke.py --fp32-routes``: only the fp32 routes' rows of phases
    15 and 16 (K1, K2 and K3 per text localisation, with split-K and with
    128 x 128 tiles alone in turns; one whole text localisation call; K1
    per ResNet-50 eval batch, K1 and K2 per Ours grid; K3 per attn-unpool
    harness encode; random-init nets,
    ``time_shapes`` on seeded operands), for comparing two trees' kernels,
    or the two tilings, in one call."""
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, probe = phase_probe()
    rate = probe["k4_gbs"] * 1e9
    student = Experiment(*CLIP_EXPERIMENTS["unpool"]).get_model()
    worst = {name: 0.0 for name in MODEL_KERNELS}
    # split-K against 128 x 128 tiles alone (the policy set to 1 split),
    # in turns
    splits = k12.tf32_splits
    for policy in ("split-K", "tiles", "tiles", "split-K"):
        say(f"fp32 routes with {policy}:")
        k12.tf32_splits = k3.tf32_splits = splits if policy == "split-K" else (lambda *_: 1)
        try:
            loc_text_kernels(student, rate, worst)
        finally:
            k12.tf32_splits = k3.tf32_splits = splits
    call_ms, busy = text_localisation_call(student)
    say(f"fp32 routes: one text localisation call (attn-unpool, 224^2): {call_ms:.2f} ms, the "
        f"card busy {busy or 0:.2f} ms of it [{CARD}]")
    say("fp32 routes of the ResNet-50 (split-K):")
    resnet_fp32_kernels(build_bcosified_resnet(FLAGSHIP, seed=SEED).model, rate, worst)
    per_shape = collections.Counter(clip_launches(student, BENCH_BATCH, SIZE, False))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 44)
    row = time_shapes(per_shape, rate, gen, tag="bench fp32 ", dtype=torch.float32)
    row = row["bcos_matmul_fwd"]
    say(f"fp32 routes: bcos_matmul_fwd per attn-unpool fp32 encode ({sum(per_shape.values())} "
        f"launches): {row['ms']:.4f} ms; bound {1e3 * row['bound_s']:.4f} ms (3xTF32), "
        f"{fp32_cores_ms(row):.4f} ms (67 TFLOP/s fp32); plain {row['plain_ms']:.4f} ms, "
        f"torch.matmul {row['library_ms']:.4f} ms [{CARD}]")
    return 0


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available", file=sys.stderr)
        return 2
    CARD = card_line()
    if sys.argv[1:] == ["--fp32-routes"]:
        say(CARD)
        return fp32_routes()
    say(f"device: {CARD} ({torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {torch.get_num_threads()} CPU threads, "
        f"{os.cpu_count()} CPUs)")
    seconds = {}
    t0 = time.perf_counter()
    phase_build()
    seconds["2 build"] = time.perf_counter() - t0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    worst = check_kernels()
    seconds["3 kernel checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    net = build_bcosified_resnet(FLAGSHIP, seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x2 = torch.rand((2, SIZE, SIZE, 3), device="cuda", generator=gen)
    x2 = torch.cat([x2, 1.0 - x2], dim=-1)
    mag = calibrate(net, x2[:1])
    say(f"calibrated BN gammas: pre-logit magnitude {mag:.3g} on the probe")
    phase_parity(net, x2)
    seconds["4 parity"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    counts, ms_explain = phase_throughput(net, x2)
    seconds["5 throughput"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k4_row, probe = phase_probe()
    seconds["6 probe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels = time_kernels(net.model, worst, counts, probe["k4_gbs"] * 1e9)
    seconds["3 kernel times"] = time.perf_counter() - t0
    kernel_ms = sum(k["ms"] for k in kernels)
    say(f"kernels' share of one fwd+explain call: {kernel_ms:.2f} of {ms_explain:.2f} ms "
        f"[{CARD}]")
    kernels.append(k4_row)

    t0 = time.perf_counter()
    phase_serving(net, x2)
    seconds["7 serving"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    train = phase_train(net, probe["k4_gbs"] * 1e9)
    seconds["8 train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with synthetic_imagenet() as exp_root:
        phase_entry(net, x2, train["step_img_s"], exp_root)
        seconds["9 entry points"] = time.perf_counter() - t0
        if k12.tma_operands.padded:
            raise AssertionError(f"{k12.tma_operands.padded} ResNet-50 calls padded their operands")
        say("TMA operand padding on the ResNet-50 paths: 0 calls")
        t0 = time.perf_counter()
        densenet = phase_densenet(x2, probe["k4_gbs"] * 1e9, worst, exp_root)
        seconds["10 densenet"] = time.perf_counter() - t0
        if k12.tma_operands.padded:
            raise AssertionError(f"{k12.tma_operands.padded} DenseNet-121 calls padded their "
                                 "operands")
        say("TMA operand padding on the DenseNet-121 paths: 0 calls")
        t0 = time.perf_counter()
        clip, students = phase_clip(x2, probe["k4_gbs"] * 1e9, worst)
        seconds["11 clip"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kd = phase_kd(students, x2, probe["k4_gbs"] * 1e9, worst, exp_root)
        seconds["12 clip kd"] = time.perf_counter() - t0
        if k12.tma_operands.padded:
            raise AssertionError(f"{k12.tma_operands.padded} CLIP-RN50 calls padded their "
                                 "operands")
        say("TMA operand padding on the CLIP-RN50 paths (KD included): 0 calls")
        t0 = time.perf_counter()
        vit = phase_vit(x2, probe["k4_gbs"] * 1e9, worst, exp_root)
        seconds["13 vit"] = time.perf_counter() - t0
        if k12.tma_operands.padded:
            raise AssertionError(f"{k12.tma_operands.padded} ViT-B/16 calls padded their "
                                 "operands")
        say("TMA operand padding on the ViT-B/16 paths: 0 calls")
        t0 = time.perf_counter()
        vit_train = phase_vit_train(x2, probe["k4_gbs"] * 1e9, worst, exp_root)
        seconds["14 vit training"] = time.perf_counter() - t0
        if k12.tma_operands.padded:
            raise AssertionError(f"{k12.tma_operands.padded} ViT training and vit_final calls "
                                 "padded their operands")
        say("TMA operand padding on the ViT training and vit_final paths: 0 calls")
        t0 = time.perf_counter()
        analyses = phase_analyses(net, students, probe["k4_gbs"] * 1e9, worst, exp_root)
        seconds["15 analyses"] = time.perf_counter() - t0
        del students
        if k12.tma_operands.padded:
            raise AssertionError(f"{k12.tma_operands.padded} analysis calls padded their "
                                 "operands")
        t0 = time.perf_counter()
        bench = phase_bench(probe["k4_gbs"] * 1e9, worst, exp_root)
        seconds["16 clip benchmark"] = time.perf_counter() - t0
    if k12.tma_operands.padded:
        raise AssertionError(f"{k12.tma_operands.padded} clip benchmark calls padded their "
                             "operands")
    say("TMA operand padding on the analyses' and the clip benchmark's paths: 0 calls")
    t0 = time.perf_counter()
    zoo = phase_zoo(x2, probe["k4_gbs"] * 1e9, worst)
    seconds["17 model zoo"] = time.perf_counter() - t0
    if k12.tma_operands.padded:
        raise AssertionError(f"{k12.tma_operands.padded} model zoo calls padded their operands")
    say("TMA operand padding on the model zoo's paths: 0 calls")
    t0 = time.perf_counter()
    zoo18 = phase_zoo_vgg_convnext(x2, probe["k4_gbs"] * 1e9, worst)
    seconds["18 zoo, VGG and ConvNeXt"] = time.perf_counter() - t0
    if k12.tma_operands.padded:
        raise AssertionError(f"{k12.tma_operands.padded} VGG and ConvNeXt calls padded their "
                             "operands")
    say("TMA operand padding on the VGG and ConvNeXt paths: 0 calls")
    t0 = time.perf_counter()
    options = phase_train_options(net, x2, probe["k4_gbs"] * 1e9, worst)
    seconds["19 training options"] = time.perf_counter() - t0
    if k12.tma_operands.padded:
        raise AssertionError(f"{k12.tma_operands.padded} training-option calls padded their "
                             "operands")
    t0 = time.perf_counter()
    with experiment_root():
        clip_vit = phase_clip_vit(x2, probe["k4_gbs"] * 1e9, worst)
    seconds["20 clip vit"] = time.perf_counter() - t0
    if k12.tma_operands.padded:
        raise AssertionError(f"{k12.tma_operands.padded} CLIP ViT calls padded their operands")
    say("TMA operand padding on the training options' and the CLIP ViT paths: 0 calls")
    t0 = time.perf_counter()
    moe_int8 = phase_moe_int8(net, x2, probe["k4_gbs"] * 1e9, worst)
    seconds["21 moe and int8"] = time.perf_counter() - t0
    if k12.tma_operands.padded:
        raise AssertionError(f"{k12.tma_operands.padded} MoE ViT and int8 calls padded their "
                             "operands")
    say("TMA operand padding on the MoE ViT and int8 serving paths: 0 calls")
    k3_row = next(k for k in kernels if k["name"] == "bcos_matmul_fwd")
    k3_row.update({"train_launches": train["launches"], "train_ms": train["ms"],
                   "train_plain_ms": train["plain_ms"],
                   "train_bound_ms": 1e3 * train["bound_s"],
                   "train_library_ms": train["library_ms"]})
    k3_row.update(kd)
    k3_row.update(vit_train)
    k3_row.update(bench)
    for row in kernels:
        row.update(densenet.get(row["name"], {}))
        row.update(clip.get(row["name"], {}))
        row.update(vit.get(row["name"], {}))
        row.update(analyses.get(row["name"], {}))
        row.update(zoo.get(row["name"], {}))
        row.update(zoo18.get(row["name"], {}))
        row.update(options.get(row["name"], {}))
        row.update(clip_vit.get(row["name"], {}))
        row.update(moe_int8.get(row["name"], {}))
        row["max_abs_err"] = worst.get(row["name"], row["max_abs_err"])
    check_bounds(kernels)

    for line in _build.build_log.splitlines():  # per kernel: registers, spills, C7518
        if any(key in line for key in ("Compiling entry", "registers", "spill", "warning")):
            say(f"ptxas: {line.strip()}")
    say("seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    say(CARD)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
