#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout. It drives `determined_tpu_torch`, never the
JAX package, through these phases, and exits non-zero at the first that
fails:

  1. device: require CUDA; print the card's name and power limit as
     `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
     them; switch TF32 off for matmuls and cuDNN.
  2. build: compile every kernel source in ops/csrc/ with nvcc (sm_90a)
     into build/kernels/, one nvcc per source, all started together; print
     each kernel function's registers and spill bytes from ptxas.
  3. the paged decode-attention kernels (the split kernel and the combine
     of the splits) against their plain version at the serving shapes:
     slots 1/8/32, H 12, Dh 64, block 16, 64 blocks a slot, permuted and
     shared pool blocks, an all-trash inactive slot, positions 0, 15, 16
     and 1023; then long contexts of 4096 keys (256 blocks, 8 splits of
     512) at slots 1 and 8 with positions at the splits' edges (511, 512,
     513, 1023, 1024, 4095). Tolerances: fp32 atol=rtol=1e-5; bf16
     atol=rtol=2e-2 (the kernel keeps P in fp32 where the plain version
     casts the probabilities to bf16). Every case is launched twice and
     the two outputs must be bit-identical (the splits merge in a fixed
     order).
  4. the flash-attention kernels (forward, dQ, dK/dV) against their plain
     versions on the same GPU tensors: the training shape (B 8, H 12, S
     1024, D 64, causal), a non-causal case, S 128 and D 128, each in fp32
     and bf16 with `bf16` off and on. Tolerances (atol, rtol): fp32 with
     `bf16` off, those of tests/test_ops.py: forward 2e-5 / 1e-4, backward
     2e-3 / 2e-3. Otherwise, set from this script's readings at these
     shapes (outputs one bf16 ulp apart, a few 1e-4 at most beyond it):
     forward and backward 1e-3 / 1e-2, except the forward output with bf16
     inputs and `bf16` on, 1e-2 / 1e-2: there the kernel rounds each k
     tile's exp(s - m) to bf16, as the Pallas kernel does, and the plain
     version the normalised probabilities, which puts up to 6e-3 beyond
     1e-2 |o| between them. lse 1e-4 / 1e-5. The plain versions compute
     the kernels' functions (fp32 logits of the inputs, fp32 P unless
     `bf16`), not `reference_attention`'s bf16 rounding. Then planted
     faults at the training shape, which each check must refuse: dQ and
     dK scaled by 1.1 (what a dS 10 % off gives), o scaled by 1.05, and
     the backward kernels run with the other `bf16` setting (P and dS
     rounded where they must not be, or not rounded where they must).
     For bf16 inputs with `bf16` off, also the share of o, dq, dk and dv
     values whose bf16 value differs from the plain version's must stay
     within `MISMATCH_LIMIT` (0.5 %): the tensor-core kernels split each
     fp32 operand exactly into three bf16 terms, so they differ only near
     rounding ties. (dq's first row is left out of that share when
     causal: its exact value is 0, one key with P = 1 gives dS = dP -
     delta = 0, so both versions hold fp32 noise there; atol holds it.)
     The three kernels run with one term of the split on the same tensors
     (P and dS rounded once) must differ in at least 10x that share: the
     one rounding atol 1e-3 cannot see in o.
  5. serving at full width through CUDA graphs: GPT-2 small (124M, random
     weights from a seed) saved with `save_params_npz`, served through
     `build_replica` and `ServingServer` in bf16 (8 slots, max_seq_len
     1024, KV block 16, prefix cache on). `compile()` must have captured
     decode (holding the paged kernel's 12 launches), every prefill bucket
     and the block copy, and prepared the sampler (`sample_s`). Eight concurrent requests share a 256-token prefix
     and carry distinct 32-token suffixes (64 new tokens, temperature 0),
     plus one at temperature 0.8. Every response must be 200 with 64
     tokens, the prefix cache must hit, every replayed decode step must
     launch the paged kernel once per layer (`attention_launches == 12 x
     decode_steps`), and its plain version must never run. Then, in turns
     with new prompts, the same burst with the engine's functions called
     eagerly (no graphs) and through the graphs again: decode step p50,
     tokens/s and TTFT of each; and one decode step at a fixed state (8
     slots at position 320) as a replay and as `paged_decode_step` called
     eagerly: host time, and device time under torch.profiler.
 5b. graphs against eager calls at full width: GPT-2 small in fp32, then
     bf16, 8 slots, max_seq_len 1024: two prefills (buckets 512 and 64,
     the second after a 256-token prefix-cache hit) and 16 decode steps
     through the engine's graphs and through the module functions eagerly
     on a copy of the same pool. Greedy tokens must be equal, fp32 logits
     within 1e-3 (phase 6's bound); whether they are bitwise equal is
     printed.
 5c. the dense layout at full width: GPT-2 small fp32, `attention_impl:
     dense`, captured like the paged engine: the same two prompts (no
     prefix hit) and 16 decode steps must give the paged engine's greedy
     tokens, logits within 1e-3.
  6. serving parity: the same weights in fp32, one prompt, 16 decode steps
     through the kernel and through the plain version (teacher-forced on
     the kernel run's tokens); the logits must agree to atol 1e-3.
  7. training at full width: `GPT2Trial` (examples/gpt2_cuda/model_def.py),
     GPT-2 small, seq_len 1024, global batch 8, bf16, remat "dots",
     attention_impl auto, through `core.init(max_length=30)` and
     `Trainer.fit`, on a memmapped token stream of repeated random 64-token
     phrases written from a seed. The loss must be finite and fall; fit
     must have replayed its step as one captured CUDA graph (its first
     flush `step_captured` 1.0), so the flash wrappers count the warm-up
     step and the capture only: each launches the forward kernel 24 times
     (12 layers, again in the remat recompute) and the dQ and dK/dV
     kernels 12 times each, and the op-end validation's captured eval
     step 12 forward launches in its warm-up and 12 in its capture, once
     for each validation batch shape (`fit_launches`; its replays are
     counted on a trace in 22a); the plain attention must never run; the op
     end must leave one COMMITTED checkpoint that `restore_state` reads
     back bit-identical; 3 more replayed steps under torch.profiler must
     trace the graph's flash launches 3 times over, all three on their
     tensor-core (wgmma) kernel functions. Every later fit on one card
     (7c, 8c, 11a, 12a, 13, 17a, 19b, 21) replays likewise, and its
     wrapper counts follow `fit_launches`.
 7b. a replica restored from phase 7's checkpoints: `build_replica` with
     `checkpoint: latest` and one adapter, a second committed checkpoint of
     the trained params with `wte` perturbed from the seed; a newer
     checkpoint is committed and corrupted first, and `latest` must fall
     back past it. GPT-2 small fp32, 8 slots, max_seq_len 256. Requests for
     the base and the adapter answered over HTTP (200, routed by name);
     the adapter-routed logits must equal a direct replica of the
     fine-tune's full params within fp32 1e-3, and differ from the base's.
     Then the same replica as a cluster runs it, a process of its own
     (`python -m determined_tpu_torch.serve`) attached to an in-process
     fake master: with 4 requests accepted (200 new tokens each) the
     master answers the allocation's preemption long-poll; the replica
     must ack, report draining, answer all 4 in full and exit 0.
 7c. a managed trial: phase 7's trial and hparams as a cluster trial
     (`DET_MASTER`, `DET_TRIAL_ID`, `DET_ALLOCATION_ID`,
     `DET_SESSION_TOKEN`, `DET_HPARAMS`, `DET_EXPERIMENT_CONFIG` with
     `shared_fs` storage under build/smoke, set for the phase only) against
     an in-process stdlib fake master that records every request; the
     prefetcher and async checkpoints on, one searcher op of 30 steps, a
     report every 5. Run A: the master answers the preemption long-poll
     (deadline 120 s) once it has seen the report of step 15; `fit` must
     ack, save, commit and register trial1-step15 (PARTIAL, then
     COMPLETED) and return at step 15; its losses at steps 5, 10 and 15
     are held to phase 7's (same init, data and kernels: atol 1e-5, and
     whether they are bitwise equal is printed). Run B: a fresh
     `core.init()` with `DET_LATEST_CHECKPOINT` = the registered id; the
     checkpoint must restore A's params and Adam moments bitwise; `fit`
     trains to 30, commits trial1-step30 and completes the op, and the
     searcher answers `done`. The master's record must hold both
     `run_prepare`s, training reports at 5-30, two COMPLETED checkpoints,
     one completed op, spans and progress; the flash launches over A and
     B must equal phase 7's formula and the plain attention never run.
     Prints each report window's step, `input_wait_ms`, `h2d_ms` and
     `prefetch_queue_depth`.
 7d. information, not a claim: 15-step fits of phase 7's trial, prefetcher
     off and on in turns (off, on, on, off), each with an async checkpoint
     at step 10 whose write overlaps steps 11-15: fit's step per report
     window, and the ms the loop spent on that save (in `save_state`, and
     blocked in the wait that committed it, from its spans), against a
     synchronous save (`async_save` off) of the same state.
  8. GPT-2 training across processes and as CUDA-graph replay.
 8a. `make_multi_step` (steps_per_call 4) against 4 `make_train_step`
     calls from the same state and batches: GPT-2 small, B 8, S 1024,
     bf16, remat "dots", two windows (the first runs step 0 eagerly and
     captures the step, the second only replays). Window-mean losses,
     grad norms and all_finite are held to rtol 1e-6 and the params to
     atol 1e-6 (the replay holds the eager step's kernels, fed the same
     floats: expected bitwise equal); whether they are bitwise equal is
     printed. The captured step must hold the flash kernels' launches
     (24 forward, 12 dQ, 12 dK/dV) and the replays must have launched
     them 7 times over. Then, information: the step replayed and eager in
     turns (host clock a window) and torch.profiler's device time a step.
 8b. the five remat policies (None, "nothing", "dots", "dots_saveable",
     "everything") at full width and 2 layers, B 8, S 1024, bf16: loss
     (rtol 1e-6) and grad norm (rtol 1e-4) held to "dots"'s, the flash
     forward launched twice a layer (once under "everything"), and the
     peak memory of each printed.
 8c. the example trial launched through `python -m
     determined_tpu_torch.launch.torch_distributed` with
     `DET_SLOT_IDS="[0]"` against the fake master of 7c (10 steps at
     phase 7's hparams): the worker must see `CUDA_VISIBLE_DEVICES=0`,
     form an NCCL process group of one with its gloo control group
     (an allgather and a broadcast of bytes over it), a DeviceMesh of the
     world, launch the flash kernels by phase 7's formula, report through
     the chief (losses at 5 and 10 held to phase 7's, atol 1e-5, bitwise
     printed) and commit a checkpoint the master registers; a serve
     replica restores it, and its logits must equal the restored params'
     forward (fp32, 1e-3). The worker starts cold, as on a fresh node:
     its kernel directory (DET_KERNEL_DIR) is empty and a compile-farm
     signature is set, so its first step builds the flash library with
     nvcc (`build_seconds` above 0, first flush `compile_cache_hit` 0)
     and uploads it to the fake master. Two ranks cannot share this one card
     (`tools/two_ranks_one_card.py`: NCCL refuses a second rank on a
     device; gloo takes all_reduce, broadcast, all_gather_into_tensor and
     reduce_scatter_tensor on CUDA tensors, but both ranks die (SIGSEGV)
     in DTensor's all-gather of a shard, which the fsdp path runs before
     every block), so the two-rank fsdp run needs a host with two cards
     and is not part of this script.
  9. training parity in fp32: the same GPT-2 small-width params (2 layers)
     and batches through the kernels and through the plain attention.
     Every leaf's step-0 gradient must agree to 1e-5 of that leaf's
     largest element. Then 3 optimizer steps (lr 0, then 1e-5): losses
     must agree to 1e-5, grad_norm to 1e-4 of itself and params to 1e-6
     (Adam moves a weight by about lr a step whatever the gradient's
     scale, so the params see a gradient's signs; the gradients and
     grad_norm see its size).
  10. times on the card (CUDA events, L2 flushed before every launch, the
     host's launch work hidden behind a device-side wait): each
     kernel, its plain version and one library call (a yardstick the port
     never calls): `scaled_dot_product_attention` over the gathered lane
     for the paged kernel (at slots 1 and 8 and positions 320, 1023 and
     4095, and 12 launches over 12 layers' pools as a decode step makes
     them), SDPA(is_causal) forward for the flash forward,
     and SDPA's autograd backward (dQ, dK and dV together) for both flash
     backward kernels; each beside the least time the card could take,
     the larger of the bytes it must move at 3.35 TB/s and its products
     at 989 TFLOP/s bf16, a product with P or dS in it counted as three
     bf16 products (`flash_bound`). Each flash kernel is timed again with
     `bf16=True`, which rounds P and dS as SDPA does. Then the
     main paths: the decode step, tokens/s and TTFT of serving, through
     the graphs and eager; the
     training step of `Trainer.fit` as it runs (its `steps_per_second`
     over the report windows after the first), tokens/s, MFU
     (`flops_per_token` against 989 TFLOP/s), and the device's idle share
     of that step from the device time of 3 more steps under
     torch.profiler. Also the first graph burst's tokens/s against the
     second's, and the managed trial's checkpoint costs.
  11. Mixture-of-Experts GPT-2 at GPT-2 small's width with the model of
     examples/gpt2/moe.yaml: 8 experts, top-2, capacity factor 1.25, aux
     coefficient 0.01 (ops/moe.py; ~521M params, the FFN of every block
     routed).
 11a. the example trial with `num_experts` 8 and `moe_top_k` 2 through
     `Trainer.fit`, 20 steps at phase 7's hparams on its token stream:
     losses finite and falling, the flash kernels launched by phase 7's
     formula and the plain attention never run, one COMMITTED checkpoint.
     Prints fit's step time and tokens/s, the device idle share (3 more
     steps under torch.profiler), the peak memory, each layer's dropped
     share of the top-2 assignments on a training batch, and MFU from the
     FLOPs a token actually runs (6 x (trunk + router + 2 experts' FFN)
     + the attention term; `flops_per_token` counts a dense FFN).
 11b. `make_multi_step` (steps_per_call 4, 2 windows) against 8
     `make_train_step` calls from the same state, MoE GPT-2 small, bf16:
     losses, grad norms and params bitwise equal (the routing replays).
 11c. 11a's checkpoint served: a bf16 replica through `build_replica` and
     `ServingServer` (8 slots, max_seq_len 1024, prefix cache on), phase
     5's burst; decode step p50, tokens/s, TTFT, a replayed step's device
     ms and kernels; graph against eager logits bitwise equal. In fp32 a
     restored replica against a dense-layout engine over its params, all
     8 slots busy with 64-token prompts (an idle slot or a padded row
     routes too and attends to other things in the two layouts), 16
     decode steps: greedy tokens equal, logits within 1e-3; and a
     64-token prompt's logits against the params' training forward
     (1e-3; bucket 64, so no padded row competes for capacity).
 11d. fp32 parity on the MoE model at full width and 2 layers, B 2, S
     1024, kernels against the plain attention: every route's chosen
     experts and kept assignments identical, then each leaf's gradient
     within 1e-5 of its largest element.

  12. long context: examples/gpt2_cuda/long_context.yaml's model (GPT-2
     small at seq_len 8192, `attention_impl: ring`) and the ring's blocks.
 12a. the long-context trial through `Trainer.fit` on one card (mesh
     `context: 1`, where the ring is the flash kernels, as the JAX ring
     falls back), the global batch of 16 cut to 4, lr 3e-4, 20 steps on
     phase 7's token stream and the op-end validation: losses finite and
     falling, flash launches by phase 7's formula, the plain attention
     never run. Prints fit's step, tokens/s, MFU, the idle share, each
     flash kernel's device ms a layer at S 8192 and the peak memory.
 12b. the ring's block schedule at B 4, S 8192, H 12, D 64 in 4 chunks,
     bf16 and fp32, in one process: ranks 0-3 in turn through
     ops/ring_attention.py's `block_forward`, `_combine`, `finish` and
     `block_backward` (each step takes the block the ring would deliver;
     the backward reads the combined lse and delta, and each block's
     dK/dV is added to that block's accumulator). o, lse, dq, dk and dv
     against one launch of each kernel at the full S and against the same
     schedule on the plain versions: fp32 within 1e-5 of the largest
     element; bf16 element by element (the comment above RING_BF16_TOL),
     with three planted faults that must be refused; each kernel launched
     10 times (4 + 3 + 2 + 1 blocks).
 12c. the kernels at the Ulysses inner shape, [4, 8192, 3, 64] bf16 (a
     quarter of the heads after the all-to-all), against their plain
     versions with phase 4's tolerances, and `ulysses_attention` at
     context 1 on the card: one launch of each kernel. The all-to-all
     itself needs two cards.
 12d. with two cards or more, the example trial at world 2 over NCCL
     (`context: 2` with ring attention, and `tensor: 2`) through the
     GPU-slot launcher, the losses and grad norms of its report windows
     against a world of one (SPLIT_LOSS_RTOL, SPLIT_NORM_RTOL); with one
     card, `[12d] not run: 1 card`.

  13. the other model families (models/mnist.py, resnet.py, diffusion.py:
     cuDNN's convolutions and plain ops, no kernel of their own), each
     sub-phase's wall time printed.
 13a. examples/mnist_cuda through `core.init(max_length=100)` and
     `Trainer.fit` with config.yaml's hparams: losses finite and falling;
     prints the validation accuracy (synthetic set) and fit's step.
 13b. ResNet-50 at ImageNet shapes as bench_resnet.py runs it (B 256,
     224x224x3, 1000 classes, bf16, sgd(0.1, momentum=0.9)):
     `make_multi_step` (10 steps a call) against 10 `make_train_step`
     calls from the same state, cudnn.benchmark off: mean loss, params,
     momentum and BN stats bitwise equal, or within rtol 1e-6 with the
     bitwise result printed. Prints the replayed and eager step,
     samples/s, MFU at 3 x 4.1 GFLOP an image against 989 TFLOP/s, the
     device ms of convolutions, BatchNorm and the rest over 3 steps under
     torch.profiler (with the idle share and the top kernels), the peak
     memory, and data/bench.ab_compare's prefetch A/B over ResNet-shaped
     host batches (information).
 13c. a ResNet-18 CIFAR stateful trial defined here (B 128, 32x32, 30
     steps) through `Trainer.fit`: losses finite and falling, validation
     on the running stats, one COMMITTED checkpoint restoring params,
     momentum and BN stats bit-identical.
 13d. ResNet-50 (B 4, 224) and the diffusion base config through the
     port on CUDA and on the CPU, TF32 off: in float64 the output, the new
     BN stats and each leaf's gradient within 1e-4 of that leaf's largest
     element; in fp32 the output and stats likewise, and the gradients'
     worst leaf against the CPU's float64 at most twice the CPU fp32's
     (ResNet-50's fp32 gradients at B 4 are themselves far from float64).
 13e. the diffusion example (base config, finetune_asha.yaml's hparams at
     one point, B 64) as a managed trial against 7c's fake master, one op
     of 60 steps: losses finite and falling, the op-end validation and a
     COMPLETED checkpoint recorded; then examples/diffusion_cuda/
     pretrain.py for 20 steps and the trial started from its file through
     `pretrained_path` (step-0 params bit-equal to the file); then
     `diffusion.sample` (n 8, T 1000) through the CUDA graph and through
     the eager loop from one generator seed: bitwise equal, every value in
     [-1, 1], the ms a denoising step of each.

  14. the torch trial APIs and the checkpoint storage backends
     (determined_tpu_torch/pytorch/, storage/), each sub-phase's wall time
     printed.
 14a. examples/gpt2_torch_cuda's `GPT2TorchTrial` (GPT-2 small, B 8, S
     1024, bf16 compute, fp32 params, AdamW lr 3e-4) through
     `pytorch.Trainer.fit` under a local `core.init(max_length=30)` with
     shared_fs storage, on phase 7's token stream: losses finite and
     falling, the flash kernels launched by phase 7's formula (8
     validation batches), the plain attention never run; a fresh trial
     restores the final checkpoint through `restore_path`, params and
     AdamW state bitwise equal. Prints fit's step (host clock after each
     step's `loss.item()`, steps 6-30) and tokens/s beside phase 7's
     `Trainer.fit` step (information). Then the trial managed against
     7c's FakeMaster: run A preempted after step 15's report, its
     checkpoint registered; run B resumes from `DET_LATEST_CHECKPOINT`
     with params bitwise equal to run A's, reports 20, 25 and 30, and
     completes the op with a COMPLETED checkpoint.
 14b. the same module as examples/gpt2_torch_cuda's `GPT2ZeroTrial` on
     `ZeroOneEngine` at world 1 (micro batch 4, accumulation 2) through
     `DeepSpeedTrainer.fit`, 20 steps: losses finite and falling,
     `optimizer_state_numel` = AdamW's two moments and step counts; an
     engine step against `torch.optim.AdamW` on the same gradients
     bitwise (and, printed, through the engine's own backward);
     `save_checkpoint` then `load_checkpoint` into a fresh engine
     bitwise. Prints the step and `optimizer_state_numel`.
 14c. GPT-2 small's TrainState from the port's Trainer (params and Adam
     moments after one step, ~1.5 GB) through `CheckpointContext` into
     `checkpoint_storage: {type: azure}` against an in-process fake Blob
     service (this script's own, stdlib only, every request's SharedKey
     signature checked): `save_state` (async), `wait`, `verify`,
     `restore_state` bitwise, no staging left; `store_path`,
     `restore_path`, `download` with a selector, `load_metadata` and
     `delete` on the same backend; then the same save and restore on
     shared_fs. Prints each one's sync and wait ms and MB/s of upload
     and restore. gcs and s3: where the SDK does not import,
     `from_config` must raise naming the package (`[14c] gcs not run:
     ...`).

  15. preflight on the card host (determined_tpu_torch/analysis), which has
     no JAX.
 15a. the port's `analyze_trial` on the trial and config of 12a (the
     example's GPT-2 small at S 8192, B 4, `attention_impl: ring` at
     context 1) and of 13b (ResNet-50 at B 256, bf16, sgd momentum, as a
     stateful trial defined here): prints params, opt_state, grads,
     batch, the activation upper bound, total_bytes and the phase's
     measured `max_memory_allocated`, in GiB, and holds total_bytes <=
     peak <= total_bytes + activations_upper_bound_bytes. Also prints the
     estimate for 12a at B 8, which runs out of memory on one card,
     beside the card's memory (information).
 15b. around 15a's analyses `torch.cuda.memory_allocated()` and
     `max_memory_allocated()` stay where they were and no kernel's
     launch count moves (the flash forward, dQ, dK/dV and paged
     wrappers); prints the GPT-2 analysis's wall ms (host time).
 15c. `python -m determined_tpu_torch.analysis preflight` in a subprocess
     on tests/fixtures/preflight_torch/{bad,clean}: exactly {DTL002,
     DTL101} and exit 1, and nothing and exit 0.

  16. pipeline parallelism and MoE over the model axes: pipeline.yaml's
     and moe.yaml's models.
 16a. pipeline.yaml's model (GPT-2 small, S 1024, bf16, remat "dots") on
     one batch shard of that config, B 32 (128 / (data 2 x fsdp 2)): the
     GPipe schedule walked in one process at 2 and 4 stages with the
     microbatch count `pipeline_microbatches_default` gives that mesh (8
     and 16): `gpt2.loss_fn_pipelined` with `parallel/pipeline.walk`
     (every stage in turn at each tick, each activation handed on in
     memory). Its loss and every gradient against `gpt2.loss_fn` on the
     same card and batch within PIPE_BF16_TOL (calibrated, beside the
     constant), and in fp32 at B 8 within 1e-5 of each leaf's largest
     element; each flash kernel launched M x the plain step's count for
     the same layers; two planted faults (a microbatch committed one tick
     late, the stages' layer slices swapped) refused; the walked step at
     2 stages against the plain step, in turns.
 16b. with two cards or more, pipeline.yaml's trial through the GPU-slot
     launcher at `pipeline: 2`, world 2, against world 1 at phase 7's
     hparams, held to 12d's SPLIT_LOSS_RTOL and SPLIT_NORM_RTOL; each
     world's step and each rank's `max_memory_allocated`. With one card,
     `[16b] not run: 1 card`.
 16c. moe.yaml's model (8 experts, top-2, GPT-2 small, bf16) at B 8, S
     1024: the first MoE block's input at random weights routed over 2
     and 4 context chunks in turn, each chunk fed the per-row counts the
     context group's gather would deliver: pos, kept, the experts and
     the capacity bitwise those of one route over the whole, the gates
     and probabilities within MOE_GATE_ATOL (a chunk's router product
     runs on fewer rows, which cuBLAS sums in another order), the aux
     loss within 1e-6 relative. The experts' FFN split over
     tensor 2 (two halves summed, the `down` bias once) against the
     unsplit FFN: fp32 within 1e-5 of the largest element, bf16 within
     MOE_TENSOR_BF16_TOL.
 16d. with two cards or more, the MoE trial at `tensor: 2` and at
     `context: 2` (ring), each against world 1 under 12d's limits. With
     one card, `[16d] not run: 1 card`.
 17a. elastic resize's checkpoints: a gloo world of 4 CPU processes
     builds phase 7's state (fsdp 4, seed 0) and writes it per rank
     (`state/rank{r}.pt`, `shards.json`), and its chief the same state in
     the one-process format; this process restores both at world 1 on
     the card into templates built from the checkpoints with no
     `init_params` call, holds them to each other bitwise, prints each
     rank's bytes written, each restore's ms and MB/s beside 14c's and
     each template's host ms, then trains ELASTIC_FIT_STEPS steps of
     `fit` resumed from the per-rank checkpoint through the kernels.
 17b. with two cards or more, an NCCL world in local mode trains phase
     7's trial at `fsdp: -1` for ELASTIC_STEPS steps, shrinking 4 -> 2 at
     step 6 and growing back at step 12 (2 -> 1 -> 2 on two or three
     cards), the resizes offered from the chief's metrics report; each
     stretch after a resize against an uninterrupted run of its width
     resumed from the checkpoint the resize took, bitwise or within
     12d's limits; each transition's `resize_downtime_ms` and its parts
     by rank (checkpoint, groups, template, restore, stream, the first
     step after), each rank's bytes read and peak memory. With one card,
     `[17b] not run: 1 card`.
 18a. the conv models over `tensor`, one card: finetune_asha.yaml's UNet
     (base, B 64: conv_in, the level-0 down conv, the lowest up conv,
     the level-1 resblock, the mid attention), ResNet-50's head and loss
     (B 256, 2048 x 1000) and MNIST's fc pair (config.yaml: hidden 128,
     B 64), each computed as 2 and 4 pieces in one process and combined
     as the collectives combine them (column pieces concatenated, row
     pieces summed with the bias once, the attention's partial logits
     summed), against the whole layer in float64 (1e-10), fp32 (1e-5;
     past it no farther from float64 than twice the whole) and bf16
     (2e-2), outputs and every gradient, as max |diff| / max |whole|.
     Planted faults that must be refused: a gather whose backward sums
     (a reduce-scatter) in the resblock, fc2's bias added t times. Each
     piece's forward device time against the whole layer's, no limit.
 18b. with two cards or more, the diffusion example's trial at `tensor:
     2` and at `context: 2`, and 13c's CIFAR trial at `tensor: 2`, each
     at world 2 against world 1 under 12d's limits, each world's step
     and each rank's peak memory. With one card, `[18b] not run: 1
     card`.
  19. the compile farm and warm start (docs/compile-farm-torch.md), each
     process with its own empty kernel directory (DET_KERNEL_DIR under
     build/smoke/p19; phase 2's build/kernels is never touched), against
     an in-process fake master with the farm's endpoints (`FarmMaster`,
     7c's with the model def, the artifact store, the jobs and links).
     19a: `python -m determined_tpu_torch.compile` for the example's
     model def at phase 7's hparams must build both libraries with nvcc,
     upload them as `aot-kernel_*` artifacts and mark the job DONE with
     the fingerprint; a second signature (another learning rate) must
     link to the first without building. 19b: 8c's launched trial, 10
     steps at phase 7's hparams, warm (`DET_COMPILE_SIGNATURE` set, the
     worker's artifacts prewarmed into `DET_COMPILE_AOT_DIR` as the agent
     does, `CUDA_HOME` and `PATH` at an nvcc that exits 1), against 8c's
     cold start: its `build_seconds` must read 0.0 with the library from
     the farm, its first flush `compile_cache_hit` 1, the flash launches
     phase 7's formula, its losses bitwise 8c's. 19c: 5's replica in a
     process of its own, beside 19a's build: a corrupt artifact under its
     serving signature must raise with nvcc unreachable, then be rebuilt
     with nvcc (the cold replica, which saves the library back into the
     node's AOT directory); then a warm replica from that artifact, with
     nvcc unreachable (`kernel_build_s` 0.0), the paged kernel launched
     once per layer a decode step in both, and in that process phase 3's
     8-slot serving case and phase 4's training-shape cases (planted
     faults included) on the two fetched libraries. Prints cold against
     warm `harness.compile` ms and replica build + capture s.
 20a. NCCL collectives in a CUDA graph, one card: a world-1 NCCL process
     group in this process; `collectives.all_reduce`, `gather_from` and
     `sum_over` (forward and backward), `sharding.gather_for_use` of a
     DTensor over the group's mesh (sync and `async_op`) and
     `step.global_mean` captured as one graph as `make_multi_step`
     captures (warm-up on a side stream, thread-local capture mode), then
     replayed on 3 new inputs: every output bitwise the same calls made
     eagerly.
 20b. with two cards or more, `make_multi_step` over a mesh of several
     processes: one launched world of 2 NCCL ranks (the port's launcher,
     local mode, its own worker script) runs in turn phase 7's GPT-2
     small (B 8, S 1024, bf16, remat "dots") at `fsdp: 2` (with and
     without `overlap_allgather`), `data: 2`, `tensor: 2`, `context: 2`
     with the ring and with Ulysses, moe.yaml's model at `expert: 2`,
     pipeline.yaml's at `pipeline: 2` (16b's settings), and 13c's
     stateful CIFAR ResNet-18 at `tensor: 2`; with four cards two such
     worlds run at once, on cards 0-1 and 2-3, each half the cases, then
     a world of 4 runs GPT-2 at `fsdp: 2, tensor: 2` and moe.yaml's
     model at `data: 2, expert: 2`. Each case: steps_per_call 4 over two
     windows (step 0 eager, the capture, then replays only) against 8
     `make_train_step` calls from the same state and batches, under 8a's
     limits (window means rtol 1e-6; every rank's params, optimizer
     moments and BatchNorm statistics atol 1e-6), bitwise or not
     printed; 7 replays made, the wrapper's flash count twice the
     graph's, and the flash kernels that torch.profiler traces on the
     card in 4 replays the graph's count x 4 (phase 7's formula at
     `fsdp`). A planted fault must be refused: rank 1 replays one step
     on its stale static batch. Information, rank 0: host ms a step
     replayed and eager in turns; from a traced window of each, device
     busy ms and NCCL ms a step (unions of kernel intervals on the
     trace's timeline) and the idle share; each rank's peak memory. With
     one card, `[20b] not run: 1 card`.
  21. `Trainer.fit` replaying its step on one card (`make_captured_step`:
     one CUDA graph a batch shape) against its eager route
     (`make_train_step`, which `fit` takes for an optimizer without
     `hyper`), each from one seed, the captured run first. 21a: GPT-2
     small bf16 (B 8, S 1024, phase 7's trial and hparams) to step 15
     with a report every 5 and a checkpoint every 5, the 8th batch drawn
     non-finite (a flag a row the loss reads on the card) under
     `health.on_nan: rollback` (the window to 10 diverges and rolls back
     to step 5), then a resume from step 15 to 20; the batches drawn have
     8, 8, 8 and 3 rows in turn, bucketed into 2 shapes. Every report's
     loss, grad_norm and all_finite and the final params, moments and
     extra held to the eager run's under 8a's limits (bitwise printed);
     each captured fit must hold 2 graphs and the flash wrappers count
     exactly their 4 captures (the rollback captured nothing again).
     Then 4 more B-8 steps on each route's last state: host ms a step in
     turns, and under torch.profiler the device busy ms (the union of
     kernel intervals), the idle share (1 - busy / host, not clipped)
     and the flash kernels traced, which for the replays must be the
     graph's count x 4; `max_memory_allocated` of each run, and of
     captured fits over 1 and 3 bucket shapes. 21b: 13c's stateful CIFAR
     ResNet-18 (B 128), 10 steps, likewise held to its eager run (BN
     stats and momentum included). 21c: the DDPM UNet (13e's hparams),
     whose loss draws its timesteps and noise from the step's generator,
     10 steps through a non-finite 7th batch and a rollback that
     reseeds the generator: the replays must draw what the eager steps
     draw.
  22. the eval step captured, and `Trainer.fit` replaying its step over a
     mesh of several processes. 22a (one card): phase 7's trial with a
     validation set of 8, 8, 3 and 3 rows (2 shapes, every batch's values
     its own), 3 steps with a pass at step 2 and one at the op end,
     through the captured eval step (`make_captured_eval_step`, the route
     fit takes) and through an eager eval step (a Trainer whose eval step
     is `make_eval_step`'s function): the validation metrics bitwise
     equal, 2 eval graphs, the wrappers counting their captures only
     (`fit_launches`), the flush after the first pass carrying
     `eval_captured` 1.0 and `eval_route` and the first flush the train
     step's keys; then passes over the captured fit's state, captured and
     eager in turns (each pass bitwise the fit's last; host ms a pass),
     one of each traced: device busy ms and, for the captured pass, the
     flash kernels on the trace, which must be its graphs' counts times
     their replays; `max_memory_allocated` of each fit. 22b (two cards or
     more): `FIT_MESH_WORKER` through the launcher in local mode, each
     case of FIT22_CASES (GPT-2 small at `fsdp: 2` with and without
     `overlap_allgather`, `tensor: 2`, `context: 2` ring, `pipeline: 2`;
     13c's CIFAR at `tensor: 2`) at world 2 (two worlds at once on four
     cards), and moe.yaml's model at `expert: 2` (at world 4 with `data:
     2` on four cards): `Trainer.fit` captured against its eager route (an
     optimizer without `hyper`) from one seed, to step 6 with the 5th
     batch non-finite (a rollback) and a checkpoint every 2 steps, then
     resumed to 8, a validation batch at each op end: the reports under
     8a's limits (bitwise printed), every rank's params, moments and
     extra, the validation equal, both fits' first flushes `step_captured`
     1.0, one train and one eval graph a rank; then a window of 4 steps
     of each route in turns: rank 0's host ms a step, the traced device
     busy and NCCL ms (unions of kernel intervals), the idle share (not
     clipped), the flash kernels traced (the graph's count x 4), the
     vote's host us a call, each rank's peak. Each world closes its core
     contexts (destroy_process_group) with the last case's graphs alive,
     and the close must return. 22c: 17b at world 2 (2 -> 1 -> 2 on
     replayed steps), every stretch bitwise its uninterrupted run, every
     width's first flush `step_captured` 1.0, and the close returning.
     With one card, `[22b] not run` and `[22c] not run`. 12d, 16b, 16d,
     17b and 18b also hold each first flush to `step_captured` 1.0.
 23. the port's searcher, autotune, client and CLI on the card. 23a: the
     port's RemoteSearchRunner drives the port's BatchSizeSearchMethod
     (start 16, max 256, 4 steps a trial) through the port's `Determined`
     client against an in-process master speaking the native master's
     custom-searcher protocol (`SearchMaster`); each Create launches
     tests/fixtures/platform_torch/autotune_gpt2.py (phase 7's GPT-2
     small through fit's replayed step at the size the search names) on
     slot 0 through the port's launcher, with this script's built
     kernels. Each size: samples/s over the steps after the capture,
     `max_memory_allocated`, wall time and how it ended (for an
     out-of-memory trial the size it tried to allocate and where); the
     best size, the failed sizes, the search's wall time, and the port
     preflight's estimate at the best and the smallest failed size beside
     the card's memory. Fails if a failed trial's log lacks
     `torch.OutOfMemoryError`, a failed size was not tried twice, a size
     below the best failed, the search did not reach Shutdown, or a trial
     that fit did not launch the flash kernels as fit does. 23b: `python
     -m determined_tpu_torch.cli preflight examples/gpt2_cuda/
     long_context.yaml examples/gpt2_cuda` exits 0 with the report the
     port's analysis gives in this process; `serve --local` of phase 5's
     config answers phase 5's lone greedy request with phase 5's tokens
     through the decode graph, then drains on SIGTERM and exits 0.

The line before the last is a JSON object with one entry per kernel
(`kernel_route` says which units the kernel ran on: "wgmma" tensor cores
or "ffma" CUDA cores; `launches` counts phase 7's path (its wrappers:
the warm-up step, the capture and the validation), phase 5's for the
paged kernel, `launches_moe` phase 11a's, 11c's for the paged kernel,
and for the flash kernels `launches_long` phase 12a's,
`launches_ring` 12b's ring schedule, `launches_torch_trial` 14a's
`pytorch.Trainer.fit`, `launches_pipeline` 16a's schedule walked over
2 stages, `launches_elastic` 17a's `fit` after the per-rank restore,
`launches_warm` 19b's warm trial (the wrappers: fit's warm-up and
capture), `launches_fit_traced` the launches torch.profiler traced in 3
replayed steps of phase 7's fit step, `launches_fit21_traced` those in
21a's 4 replayed steps, and `launches_multi_mesh` the launches
traced on the card (torch.profiler) in 4 replays of 20b's `fsdp: 2`
graph on rank 0 (null with one card), `launches_eval22_traced` those in
22a's captured validation pass, `launches_fit_mesh_traced` those in 4
replayed fit steps of 22b's `fsdp: 2` case on rank 0 (null with one
card), `launches_autotune` the wrappers' counts summed over 23a's
trials that fit, for the paged kernel
`launches_warm_per_decode_step` 19c's warm replica and
`launches_det_serve` the launches 23b's replica's decode graph held
(its `attention_launches`), and `long_ms` a
launch's device
time in 12a's steps, at B 4, S 8192, under torch.profiler, beside its
bound at that shape, `long_bound_ms`); the last line is `{"ok": true,
"device": {...}}`.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1


def phase_device():
    if not os.path.isdir(os.path.join(ROOT, "determined_tpu_torch")):
        fail("determined_tpu_torch/ not found beside chip_smoke.py: run it "
             "from the root of a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[device] {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return card


# ------------------------------------------------------------------ phase 2


KERNEL_SOURCES = ("paged_attention", "flash_attention")


def phase_build():
    from determined_tpu_torch.ops import _build

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        paths = dict(zip(KERNEL_SOURCES, pool.map(_build.build,
                                                  KERNEL_SOURCES)))
    for name in KERNEL_SOURCES:
        _build.load(name)
    secs = time.monotonic() - t0
    for name, path in paths.items():
        say(f"[build] {path.relative_to(ROOT)} from "
            f"determined_tpu_torch/ops/csrc/{name}.cu for sm_90a "
            f"({_build.build_seconds[name]:.2f} s)")
        for line in ptxas_summary(_build.build_log.get(name, "")):
            say(f"[build]   {line}")
    say(f"[build] all kernels built and loaded in {secs:.2f} s")


def _demangle(names):
    """Readable kernel names (c++filt where the host has it)."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        readable = out.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        readable = []
    if len(readable) != len(names):
        return list(names)
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ") for n in readable]


def ptxas_summary(log):
    """One line per kernel of nvcc's `-Xptxas -v` output: registers and
    spill bytes, plus any ptxas warning (e.g. wgmma serialised)."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, f"{m.group(1)} registers, {spill}"))
            name = None
    readable = _demangle([n for n, _ in rows])
    lines = [f"{n}: {info}" for n, (_, info) in zip(readable, rows)]
    return lines + [line.strip() for line in log.splitlines()
                    if "warning" in line.lower()]


# ------------------------------------------------------------------ phase 3


def make_case(slots, dtype, gen, H=12, Dh=64, bs=16, mb=64,
              fixed=(1023, 600, 0, 15, 16)):
    """Kernel inputs at serving shapes: a permuted pool, slot 1 sharing the
    first half of slot 0's blocks, the last slot inactive (all-trash table,
    position 0) when there are several, positions `fixed` and then
    random."""
    import torch

    P = slots * mb + 1  # + trash
    trash = P - 1
    dev = "cuda"
    q = torch.randn(slots, H, Dh, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, bs, H, Dh, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, bs, H, Dh, generator=gen, device=dev).to(dtype)
    tables = torch.randperm(trash, generator=gen, device=dev)
    tables = tables[:slots * mb].reshape(slots, mb).to(torch.int32)
    pos = torch.randint(0, mb * bs, (slots,), generator=gen, device=dev)
    n = min(slots, len(fixed))
    pos[:n] = torch.tensor(fixed[:n], device=dev)
    if slots > 2:
        tables[1, :mb // 2] = tables[0, :mb // 2]
    if slots > 1:
        tables[-1] = trash
        pos[-1] = 0
    return q, kp, vp, tables.contiguous(), pos.to(torch.int32)


# (slots, mb, positions): the serving shapes, then contexts of 4096 keys
# (8 splits of 512) with positions at the splits' edges.
PAGED_CASES = (
    (1, 64, (1023, 600, 0, 15, 16)), (8, 64, (1023, 600, 0, 15, 16)),
    (32, 64, (1023, 600, 0, 15, 16)), (1, 256, (4095,)), (1, 256, (512,)),
    (8, 256, (4095, 511, 512, 513, 1023, 1024, 4000)))


def phase_kernel_check(cases=PAGED_CASES):
    import torch

    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for slots, mb, fixed in cases:
            args = make_case(slots, dtype, gen, mb=mb, fixed=fixed)
            out = paged_attention_cuda(*args)
            again = paged_attention_cuda(*args)
            torch.cuda.synchronize()
            ref = paged_attention_reference(*args)
            err = (out.float() - ref.float()).abs()
            bad = err > tol[dtype] + tol[dtype] * ref.float().abs()
            max_err = float(err.max())
            worst = max(worst, max_err)
            same = torch.equal(out, again)
            say(f"[kernel] paged_attention {str(dtype)[6:]} slots={slots} "
                f"keys={mb * 16} positions={args[4].tolist()[:8]}"
                f"{'...' if slots > 8 else ''} max_abs_err={max_err:.3e} "
                f"(atol=rtol={tol[dtype]:g}); two launches bit-identical: "
                f"{same}")
            if not torch.isfinite(out.float()).all():
                fail(f"paged_attention {dtype} slots={slots}: non-finite "
                     "output")
            if bad.any():
                fail(f"paged_attention {dtype} slots={slots} keys="
                     f"{mb * 16}: {int(bad.sum())} elements outside "
                     f"tolerance (max err {max_err:.3e})")
            if not same:
                fail(f"paged_attention {dtype} slots={slots} keys="
                     f"{mb * 16}: two launches on the same inputs differ")
    return worst


# ------------------------------------------------------------------ phase 4


FLASH_CASES = (  # (B, S, H, D, causal): the training shape first
    (8, 1024, 12, 64, True), (2, 512, 4, 64, False), (4, 128, 12, 64, True),
    (2, 256, 4, 128, True))


def flash_inputs(b, s, h, d, dtype, gen):
    """q, k, v as the per-head views of one fused [B, S, 3*H*D] product
    (the strides the model hands the kernels), and a contiguous dO."""
    import torch

    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device="cuda")
    q, k, v = (t.view(b, s, h, d) for t in qkv.to(dtype).split(h * d, -1))
    dout = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    return q, k, v, dout


def flash_tolerances(dtype, bf16):
    """(atol, rtol) of o, lse and the gradients (see the docstring)."""
    import torch

    if dtype == torch.float32 and not bf16:
        return {"o": (2e-5, 1e-4), "lse": (1e-4, 1e-5), "grad": (2e-3, 2e-3)}
    o_tol = (1e-2, 1e-2) if dtype == torch.bfloat16 and bf16 else (1e-3, 1e-2)
    return {"o": o_tol, "lse": (1e-4, 1e-5), "grad": (1e-3, 1e-2)}


# The share of bf16 elements of o, dq, dk and dv that may differ from the
# plain version's bf16 value, for bf16 inputs with `bf16` off. The exact
# split differs from the fp32 plain version only in the order of its sums,
# so a bf16 value differs only near a rounding tie: a calibration run
# measured 0.104-0.113 % (o, dk, dv) and 0.112 % (dq) at the training
# shape, where the kernels run with one term of the split (P and dS rounded
# to bf16 once) differ in 38.7-42.1 %.
MISMATCH_LIMIT = 0.005


def mismatch(got, want):
    """Share of elements whose values differ (both in the output dtype)."""
    return float((got != want).float().mean())


def dq_rows(t, causal):
    """dq [B, S, H, D] without its first row when causal: there the exact
    gradient is 0 (one key, P = 1, dS = dP - delta = 0) and both versions
    hold fp32 noise, which no bf16 comparison can hold; atol does."""
    return t[:, 1:] if causal else t


def held(got, want, atol, rtol):
    """(max abs error, the largest share of its allowance an element uses:
    err / (atol + rtol |want|), at most 1 when every element is held)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return float(err.max()), float((err / (atol + rtol * want.abs())).max())


def phase_flash_check(cases=FLASH_CASES):
    import torch

    from determined_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for b, s, h, d, causal in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for bf16 in (False, True):
                q, k, v, dout = flash_inputs(b, s, h, d, dtype, gen)
                o, lse = fa.flash_fwd_cuda(q, k, v, causal, bf16)
                delta = fa.flash_delta(dout, o)
                dq = fa.flash_dq_cuda(q, k, v, dout, lse, delta, causal, bf16)
                dk, dv = fa.flash_dkv_cuda(q, k, v, dout, lse, delta, causal,
                                           bf16)
                torch.cuda.synchronize()
                o_ref, lse_ref = fa.flash_fwd_reference(q, k, v, causal, bf16)
                dq_ref = fa.flash_dq_reference(q, k, v, dout, lse, delta,
                                               causal, bf16)
                dk_ref, dv_ref = fa.flash_dkv_reference(
                    q, k, v, dout, lse, delta, causal, bf16)
                tol = flash_tolerances(dtype, bf16)
                checks = (("fwd", "o", o, o_ref, tol["o"]),
                          ("fwd", "lse", lse, lse_ref, tol["lse"]),
                          ("dq", "dq", dq, dq_ref, tol["grad"]),
                          ("dkv", "dk", dk, dk_ref, tol["grad"]),
                          ("dkv", "dv", dv, dv_ref, tol["grad"]))
                errs = []
                for kernel, what, got, want, (atol, rtol) in checks:
                    if not torch.isfinite(got.float()).all():
                        fail(f"flash {what} B{b} S{s} H{h} D{d} {dtype} "
                             f"bf16={bf16}: non-finite output")
                    max_err, share = held(got, want, atol, rtol)
                    worst[kernel] = max(worst[kernel], max_err)
                    errs.append(f"{what} {max_err:.2e} ({share:.2f} of "
                                f"{atol:g}+{rtol:g}|x|)")
                    if share > 1.0:
                        fail(f"flash {what} B{b} S{s} H{h} D{d} causal="
                             f"{causal} {dtype} bf16={bf16}: max err "
                             f"{max_err:.3e} outside atol={atol:g} "
                             f"rtol={rtol:g} ({share:.2f} of the allowance)")
                say(f"[flash] B{b} S{s} H{h} D{d} causal={causal} "
                    f"{str(dtype)[6:]} bf16={bf16}: max_abs_err "
                    + ", ".join(errs))
                if dtype == torch.bfloat16 and not bf16:
                    shares = {what: mismatch(got, want) for what, got, want in
                              (("o", o, o_ref),
                               ("dq", dq_rows(dq, causal),
                                dq_rows(dq_ref, causal)),
                               ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
                    say("[flash]   bf16 values that differ from the plain "
                        "version's: " + ", ".join(
                            f"{w} {x * 100:.3f}%" for w, x in shares.items())
                        + f" (each held to {MISMATCH_LIMIT * 100:g}%; dq "
                        f"without row 0 when causal)")
                    for what in ("o", "dq", "dk", "dv"):
                        if shares[what] > MISMATCH_LIMIT:
                            fail(f"flash {what} B{b} S{s} H{h} D{d} bf16 "
                                 f"inputs: {shares[what] * 100:.3f}% of the "
                                 "bf16 values differ from the plain "
                                 f"version's (limit {MISMATCH_LIMIT * 100:g}%)")
                if (b, s, h, d, causal) == FLASH_CASES[0] and \
                        dtype == torch.bfloat16:
                    planted_faults(fa, (q, k, v, dout, lse, delta), tol,
                                   bf16, o_ref, dq_ref, dk_ref, dv_ref,
                                   o, dq, dk, causal)
    return worst


def planted_faults(fa, args, tol, bf16, o_ref, dq_ref, dk_ref, dv_ref, o,
                   dq, dk, causal):
    """Wrong results the checks above must refuse, at the training shape:
    fails the run if any of them would pass."""
    import torch

    q, k, v, dout, lse, delta = args
    dq_x = fa.flash_dq_cuda(q, k, v, dout, lse, delta, True, not bf16)
    dk_x, dv_x = fa.flash_dkv_cuda(q, k, v, dout, lse, delta, True, not bf16)
    torch.cuda.synchronize()
    faults = (("dQ x 1.1 (dS 10% off)", dq * 1.1, dq_ref, tol["grad"]),
              ("dK x 1.1 (dS 10% off)", dk * 1.1, dk_ref, tol["grad"]),
              ("o x 1.05", o * 1.05, o_ref, tol["o"]),
              (f"dQ with bf16={not bf16}", dq_x, dq_ref, tol["grad"]),
              (f"dK with bf16={not bf16}", dk_x, dk_ref, tol["grad"]),
              (f"dV with bf16={not bf16}", dv_x, dv_ref, tol["grad"]))
    seen = []
    for what, got, want, (atol, rtol) in faults:
        _, share = held(got, want, atol, rtol)
        seen.append(f"{what}: {share:.2f}")
        if share <= 1.0:
            fail(f"planted fault '{what}' (bf16={bf16}) passes the check "
                 f"at atol={atol:g} rtol={rtol:g}")
    say(f"[flash] planted faults at the training shape, bf16 inputs, "
        f"bf16={bf16}, each refused (share of the allowance, > 1 = "
        "refused): " + "; ".join(seen))
    if bf16:
        return
    # One term of the split where there must be three: P and dS rounded to
    # bf16 once. Only the share of differing bf16 values can see it in o.
    o_x = fa.flash_fwd_cuda(q, k, v, True, True)[0]
    torch.cuda.synchronize()
    seen = []
    for what, got, want in (("o", o_x, o_ref),
                            ("dq", dq_rows(dq_x, causal),
                             dq_rows(dq_ref, causal)),
                            ("dk", dk_x, dk_ref), ("dv", dv_x, dv_ref)):
        share = mismatch(got, want)
        seen.append(f"{what} {share * 100:.3f}%")
        if share <= 10 * MISMATCH_LIMIT:
            fail(f"planted fault '{what} with one term of the split' differs "
                 f"in {share * 100:.3f}% of its values: not 10x the limit "
                 f"of {MISMATCH_LIMIT * 100:g}%")
    say("[flash] planted fault, one term of the split (round_bf16=1 on the "
        "same tensors), refused by the share of differing bf16 values "
        f"(limit {MISMATCH_LIMIT * 100:g}%, needs 10x): " + ", ".join(seen))


# ------------------------------------------------------------------ phase 5


def _post(url, body, timeout=600.0):
    req = urllib.request.Request(
        url, method="POST", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(url, timeout=60.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def write_model(workdir):
    """GPT-2 small with random weights from SEED, saved as .npz."""
    import torch

    from determined_tpu_torch.models import gpt2

    cfg = gpt2.Config.small()
    t0 = time.monotonic()
    params = gpt2.init(torch.Generator().manual_seed(SEED), cfg)
    path = os.path.join(workdir, "gpt2_small.npz")
    gpt2.save_params_npz(path, params)
    say(f"[serve] GPT-2 small: {gpt2.param_count(cfg):,} params, init + "
        f"save {time.monotonic() - t0:.1f} s")
    return path


def serve_burst(url, rng, vocab):
    """The phase's traffic over HTTP: 8 concurrent requests sharing a
    256-token prefix with distinct 32-token suffixes (64 new tokens,
    temperature 0), plus one unrelated at temperature 0.8. Checks every
    answer -> (responses, wall seconds)."""
    prefix = rng.integers(0, vocab, 256).tolist()
    bodies = [{"tokens": prefix + rng.integers(0, vocab, 32).tolist(),
               "max_new_tokens": 64, "temperature": 0.0} for _ in range(8)]
    bodies.append({"tokens": rng.integers(0, vocab, 64).tolist(),
                   "max_new_tokens": 64, "temperature": 0.8})
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
        results = list(pool.map(
            lambda b: _post(url + "/v1/generate", b), bodies))
    wall = time.perf_counter() - t0
    for i, (status, body) in enumerate(results):
        if status != 200:
            fail(f"request {i}: HTTP {status} {body}")
        toks = body["tokens"]
        if len(toks) != 64 or not all(0 <= t < vocab for t in toks):
            fail(f"request {i}: {len(toks)} tokens, expected 64 in "
                 f"[0, {vocab})")
    return [body for _, body in results], wall


def burst_summary(bodies, wall, step_s):
    tokens = sum(len(b["tokens"]) for b in bodies)
    return {"decode_step_ms": statistics.median(step_s) * 1e3,
            "decode_steps": len(step_s), "tokens_per_s": tokens / wall,
            "tokens": tokens, "wall_s": wall,
            "ttft_p50_ms": statistics.median(b["ttft_ms"] for b in bodies)}


def phase_serve(workdir, ckpt, card):
    import numpy as np

    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)
    from determined_tpu_torch.serve.http import ServingServer
    from determined_tpu_torch.serve.task import build_replica, load_config

    cfg_path = os.path.join(workdir, "serve.json")
    with open(cfg_path, "w") as f:
        json.dump({"serving": {
            "model": "gpt2",
            "model_config": {"model_size": "small", "dtype": "bfloat16"},
            "checkpoint": ckpt,
            "max_batch_size": 8,
            "max_seq_len": 1024,
            "kv_block_size": 16,
            "prefix_cache": True,
            "seed": SEED,
        }}, f)
    config = load_config(cfg_path)

    # The main path runs from here: every count starts at 0.
    paged_attention_cuda.launches = 0
    paged_attention_reference.calls = 0
    t0 = time.monotonic()
    engine, batcher = build_replica(config)
    decode_s = []
    decode = engine.decode

    def timed_decode(*args):
        t = time.perf_counter()
        out = decode(*args)  # ends in a device-to-host copy: synchronised
        decode_s.append(time.perf_counter() - t)
        return out

    engine.decode = timed_decode
    batcher.start()
    say(f"[serve] replica built and captured in {time.monotonic() - t0:.1f} "
        f"s: {json.dumps(engine.compile_stats)}")
    if "sample_s" not in engine.compile_stats:
        fail("compile() did not prepare the sampler")
    n_layer = engine.cfg.n_layer
    graphs = engine.stats()["cuda_graphs"]
    want = {"decode", "copy_block"} | {
        f"prefill_{b}" for b in engine.prefill_buckets}
    say(f"[serve] CUDA graphs captured (paged-kernel launches each holds): "
        f"{graphs}")
    if set(graphs) != want or graphs["decode"] != n_layer:
        fail(f"captured graphs {graphs}: expected {sorted(want)} with "
             f"{n_layer} paged launches in decode")
    server = ServingServer(batcher, host="127.0.0.1", port=0).start()
    url = f"http://127.0.0.1:{server.port}"
    vocab = engine.cfg.vocab_size
    rng = np.random.default_rng(SEED)
    captured = engine._graphs
    runs = {"graph": [], "eager": []}
    try:
        bodies, wall = serve_burst(url, rng, vocab)
        status, raw = _get(url + "/v1/stats")
        stats = json.loads(raw)
        wrapper_launches = paged_attention_cuda.launches
        ref_calls = paged_attention_reference.calls
        m_status, metrics = _get(url + "/metrics")
        h_status, health = _get(url + "/healthz")
        if (status, m_status, h_status) != (200, 200, 200):
            fail(f"stats/metrics/healthz: {status}/{m_status}/{h_status}")
        if b"det_serve_prefix_cache_hit_rate" not in metrics:
            fail("/metrics lacks det_serve_prefix_cache_hit_rate")
        say(f"[serve] {len(bodies)} requests answered 200 with 64 tokens "
            "each")
        runs["graph"].append(burst_summary(bodies, wall, decode_s))
        # In turns (graph, eager, eager, graph), with new prompts each time:
        # the same burst with the engine's functions called eagerly (its CPU
        # branch: no graphs) and through the graphs. The eager runs launch
        # the kernel through its wrapper: timing runs do not count.
        for mode in ("eager", "eager", "graph"):
            engine._graphs = None if mode == "eager" else captured
            decode_s.clear()
            bodies_m, wall_m = serve_burst(url, rng, vocab)
            runs[mode].append(burst_summary(bodies_m, wall_m, decode_s))
        # One greedy request alone through the graphs: 23b's reference.
        prompt = rng.integers(0, vocab, 48).tolist()
        status, body = _post(url + "/v1/generate", {
            "tokens": prompt, "max_new_tokens": 32, "temperature": 0.0})
        if status != 200 or len(body["tokens"]) != 32:
            fail(f"the greedy request: HTTP {status} {body}")
        greedy = {"prompt": prompt, "tokens": body["tokens"]}
    finally:
        engine._graphs = captured
        server.stop()
        batcher.stop()
    kv = stats["kv_blocks"]
    est = stats["engine"]
    replayed = est["attention_launches"]
    # + the decode graph's one replay at compile (not through decode()).
    launches = wrapper_launches + replayed + graphs["decode"]
    say(f"[serve] kv_blocks: prefix_hit_tokens={kv['prefix_hit_tokens']} "
        f"prefix_hits={kv['prefix_hits']} hit_rate="
        f"{kv['prefix_cache_hit_rate']}")
    say(f"[serve] decode_steps={est['decode_steps']} attention_launches="
        f"{replayed} (replayed from the decode graph); paged kernel launches "
        f"on the whole path: {launches} ({wrapper_launches} through the "
        f"wrapper: the warm-up and the capture; {graphs['decode']} in the "
        f"replay at compile) reference calls={ref_calls}")
    if kv["prefix_hit_tokens"] <= 0:
        fail("the shared 256-token prefix never hit the prefix cache")
    if est["decode_steps"] <= 0 or replayed != n_layer * est["decode_steps"]:
        fail(f"attention_launches {replayed} != {n_layer} x decode_steps "
             f"{est['decode_steps']}")
    if ref_calls != 0:
        fail(f"the plain version ran {ref_calls} times on the serving path")
    for mode in ("graph", "eager"):
        for i, r in enumerate(runs[mode]):
            say(f"[serve] [{card}] burst {mode} #{i + 1}: decode step p50 "
                f"{r['decode_step_ms']:.3f} ms over {r['decode_steps']} "
                f"steps, {r['tokens_per_s']:.1f} tokens/s ({r['tokens']} "
                f"tokens in {r['wall_s']:.2f} s), TTFT p50 "
                f"{r['ttft_p50_ms']:.1f} ms")
    steps = decode_step_times(engine, card)
    engine_stats = engine.compile_stats
    paged_attention_cuda.launches = wrapper_launches
    del engine, batcher, captured
    _free_cuda()
    return {"launches": launches, "runs": runs, "steps": steps,
            "compile_stats": dict(engine_stats), "greedy": greedy,
            **runs["graph"][0]}


def _free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def decode_step_times(engine, card, n=30):
    """One decode step two ways at one state of the serving engine (8
    slots at position 320 over their own blocks, greedy): the replayed
    graph (`engine.decode`: inputs copied in, replay, sample, one
    device-to-host copy) and `smodel.paged_decode_step` called eagerly on
    the same engine state, then the same sampler and copy. Host clock
    around each step, in turns (graph, eager, eager, graph); then the
    device time of one step each: CUDA events around 20 back-to-back
    replays of the decode graph alone, and torch.profiler over 5 steps of
    each (kernel time summed, kernels counted)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from determined_tpu_torch.serve import model as smodel

    slots, mb = engine.slots, engine.max_blocks_per_seq
    tables = np.arange(slots * mb, dtype=np.int32).reshape(slots, mb)
    engine._tables[:] = tables
    tokens = np.random.default_rng(SEED + 9).integers(
        0, engine.cfg.vocab_size, slots).astype(np.int32)
    positions = np.full((slots,), 320, np.int32)
    temps = np.zeros((slots,), np.float32)
    dev = engine.device
    t_tokens, t_pos, t_tables = (torch.from_numpy(a).to(dev)
                                 for a in (tokens, positions, tables))
    t_temps = torch.from_numpy(temps).to(dev)

    def graph_step():
        return engine.decode(tokens, positions, temps)

    def eager_step():
        with torch.inference_mode():
            logits = smodel.paged_decode_step(
                engine.params, engine._cache, t_tokens, t_pos, t_tables,
                engine.cfg, attention_impl=engine.attention_impl)[1]
            return smodel.sample(logits, t_temps, engine._generator).cpu()

    fns = {"graph": graph_step, "eager": eager_step}
    host = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        fns[mode]()
        for _ in range(n):
            t = time.perf_counter()
            fns[mode]()
            host[mode].append(time.perf_counter() - t)
    graph = engine._graphs["decode"][0]
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(20):
        graph.replay()
    e1.record()
    e1.synchronize()
    replay_ms = e0.elapsed_time(e1) / 20
    device = {}
    for mode, fn in fns.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        us, kernels, top = 0.0, 0, []
        for ev in prof.key_averages():
            if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
                continue
            t = getattr(ev, "self_device_time_total", None)
            t = ev.self_cuda_time_total if t is None else t
            if t > 0:
                us += t
                kernels += ev.count
                top.append((t / 1e3 / 5, ev.count / 5, ev.key))
        device[mode] = {"device_ms": us / 1e3 / 5, "kernels": kernels / 5,
                        "top": sorted(top, reverse=True)[:8]}
    out = {mode: {"host_p50_ms": statistics.median(v) * 1e3, **device[mode]}
           for mode, v in host.items()}
    out["replay_event_ms"] = replay_ms
    for mode in ("graph", "eager"):
        r = out[mode]
        say(f"[serve] [{card}] decode step at 8 slots, position 320, "
            f"{mode}: host p50 {r['host_p50_ms']:.3f} ms over {2 * n} steps; "
            f"device {r['device_ms']:.3f} ms a step in {r['kernels']:.0f} "
            f"kernels (torch.profiler, 5 steps; sampler and copies included)")
        for ms, count, name in r["top"]:
            say(f"[serve]   {ms:7.4f} ms a step in {count:5.1f} kernels  "
                f"{name[:100]}")
    say(f"[serve] [{card}] one replay of the decode graph alone: "
        f"{replay_ms:.3f} ms of device time (CUDA events, 20 replays back "
        "to back)")
    return out


# ------------------------------------------------------------ phase 5b, 5c


class EagerTwin:
    """The module functions called eagerly on a copy of an engine's paged
    cache, with the inputs the engine's graphs read: the graphs' yardstick.
    It takes the engine's block tables as they stand after each prefill."""

    def __init__(self, engine):
        self.engine = engine
        self.cache = {k: v.clone() for k, v in engine._cache.items()}

    def prefill_logits(self, slot, tokens, block_table, cached_len):
        import torch

        from determined_tpu_torch.serve import model as smodel

        e, dev = self.engine, self.engine.device
        suffix = tokens[cached_len:]
        padded = torch.zeros(e.bucket_for(len(suffix)), dtype=torch.int32,
                             device=dev)
        padded[:len(suffix)] = torch.from_numpy(suffix).to(dev)
        table = torch.from_numpy(block_table).to(dev)
        with torch.inference_mode():
            return smodel.paged_prefill(e.params, self.cache, padded,
                                        len(suffix), cached_len, table,
                                        e.cfg)[1]

    def decode_logits(self, tokens, positions):
        import torch

        from determined_tpu_torch.serve import model as smodel

        e, dev = self.engine, self.engine.device
        t, p, tbl = (torch.from_numpy(a).to(dev)
                     for a in (tokens, positions, e._tables))
        with torch.inference_mode():
            return smodel.paged_decode_step(
                e.params, self.cache, t, p, tbl, e.cfg,
                attention_impl=e.attention_impl)[1]


def two_prompts(engine, rng):
    """Prompt A (300 tokens: bucket 512) for slot 0 over slot 0's blocks;
    prompt B = A's first 256 tokens + 40 (a prefix-cache hit of 16 blocks,
    its suffix in bucket 64) for slot 1, sharing A's first 16 blocks."""
    import numpy as np

    a = rng.integers(0, engine.cfg.vocab_size, 300).astype(np.int32)
    b = np.concatenate([a[:256], rng.integers(0, engine.cfg.vocab_size, 40)
                        ]).astype(np.int32)
    mb = engine.max_blocks_per_seq
    table_a = np.arange(mb, dtype=np.int32)
    table_b = np.concatenate([table_a[:16], np.arange(
        2 * mb, 3 * mb - 16, dtype=np.int32)])
    return ((0, a, table_a, 0), (1, b, table_b, 256))


def generate_logits(engine, prompts, steps, twin=None):
    """Greedy generation through `engine.prefill_logits` / `decode_logits`
    (the graphs) of `prompts` [(slot, tokens, table, cached_len)], and the
    same inputs through `twin` when given (fed the engine's tokens) ->
    (tokens per slot, engine logits, twin logits, all steps' equal argmax)."""
    import numpy as np

    slots = engine.slots
    last = np.zeros((slots,), np.int32)
    positions = np.zeros((slots,), np.int32)
    got, want, same = [], [], True
    for slot, tokens, table, cached in prompts:
        g = engine.prefill_logits(slot, tokens, block_table=table,
                                  cached_len=cached).clone()
        got.append(g[None])
        if twin is not None:
            w = twin.prefill_logits(slot, tokens, table, cached)
            want.append(w[None])
            same &= int(w.argmax()) == int(g.argmax())
        last[slot], positions[slot] = int(g.argmax()), len(tokens)
    active = [slot for slot, *_ in prompts]
    out_tokens = {slot: [int(last[slot])] for slot in active}
    for _ in range(steps):
        g = engine.decode_logits(last, positions)[active].clone()
        got.append(g)
        if twin is not None:
            w = twin.decode_logits(last, positions)[active]
            want.append(w)
            same &= bool((w.argmax(-1) == g.argmax(-1)).all())
        nxt = g.argmax(-1).int().cpu().numpy()
        for i, slot in enumerate(active):
            last[slot] = nxt[i]
            positions[slot] += 1
            out_tokens[slot].append(int(nxt[i]))
    for slot in active:
        engine.release_slot(slot)
    return out_tokens, got, want, same


def max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def phase_graph_vs_eager(ckpt, card):
    """GPT-2 small at full width, fp32 then bf16, 8 slots, max_seq_len
    1024: two prefills (buckets 512 and 64, the second a prefix-cache hit)
    and 16 decode steps through the engine's graphs and through the module
    functions eagerly on a copy of the same pool. Greedy tokens must be
    equal; fp32 logits within 1e-3 (phase 6's bound). Returns the fp32
    engine's greedy generation for phase 5c."""
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve.engine import ServingEngine

    params = gpt2.load_params_npz(ckpt)
    fp32_ref = None
    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(gpt2.Config.small(), dtype=dtype)
        engine = ServingEngine(params, cfg, slots=8, max_seq_len=1024,
                               kv_block_size=16, seed=SEED, device="cuda")
        t0 = time.monotonic()
        engine.compile()
        capture_s = time.monotonic() - t0
        prompts = two_prompts(engine, np.random.default_rng(SEED + 10))
        toks, got, want, same = generate_logits(
            engine, prompts, 16, twin=EagerTwin(engine))
        worst = max_diff(got, want)
        bitwise = all(torch.equal(x, y) for x, y in zip(got, want))
        say(f"[graphs] [{card}] GPT-2 small {str(dtype)[6:]}: captured in "
            f"{capture_s:.1f} s; prefills (bucket 512, bucket 64 after a "
            f"256-token prefix hit) + 16 decode steps, graph vs eager: greedy "
            f"tokens equal {same}, max |logit diff| {worst:.3e}, bitwise "
            f"equal {bitwise}")
        if not same:
            fail(f"graph and eager greedy tokens differ ({dtype})")
        if dtype == torch.float32:
            if worst > 1e-3:
                fail(f"graph vs eager fp32 logits differ by {worst:.3e} > "
                     "1e-3")
            # Phase 5c's yardstick: the same two prompts without the
            # prefix hit (the dense layout has no prefix cache), each over
            # its own slot's blocks.
            mb = engine.max_blocks_per_seq
            no_hit = [(s, t, np.arange(s * mb, (s + 1) * mb, dtype=np.int32),
                       0) for s, t, _, _ in prompts]
            toks, got, _, _ = generate_logits(engine, no_hit, 16)
            fp32_ref = (no_hit, toks, got)
        del engine
        _free_cuda()
    return fp32_ref


def phase_dense(ckpt, paged_ref, card):
    """The dense layout at full width: GPT-2 small fp32, attention_impl
    dense, 8 slots, max_seq_len 1024, captured like the paged engine. The
    same two prompts must give the paged replica's greedy tokens, and
    logits within 1e-3."""
    import dataclasses

    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve.engine import ServingEngine

    cfg = dataclasses.replace(gpt2.Config.small(), dtype=torch.float32)
    engine = ServingEngine(gpt2.load_params_npz(ckpt), cfg, slots=8,
                           max_seq_len=1024, attention_impl="dense",
                           seed=SEED, device="cuda")
    engine.compile()
    graphs = engine.stats()["cuda_graphs"]
    prompts, want_toks, want = paged_ref
    toks, got, _, _ = generate_logits(engine, prompts, 16)
    worst = max_diff(got, want)
    say(f"[dense] [{card}] GPT-2 small fp32, attention_impl dense, graphs "
        f"{sorted(graphs)}: the two prompts (300 and 296 tokens) + 16 "
        f"decode steps, greedy tokens equal the paged replica's "
        f"{toks == want_toks}, max |logit diff| {worst:.3e} (atol 1e-3)")
    if toks != want_toks or worst > 1e-3:
        fail(f"the dense layout differs from the paged one: tokens equal "
             f"{toks == want_toks}, max |logit diff| {worst:.3e}")
    del engine
    _free_cuda()


# ------------------------------------------------------------------ phase 6


def phase_parity(ckpt):
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve import model as smodel

    cfg = dataclasses.replace(gpt2.Config.small(), dtype=torch.float32)
    params = gpt2.params_from_numpy(gpt2.load_params_npz(ckpt), "cuda")
    bs, mb = 16, 64
    table = torch.arange(mb, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    prompt = rng.integers(0, cfg.vocab_size, 40)
    padded = torch.zeros(64, dtype=torch.int64, device="cuda")
    padded[:40] = torch.from_numpy(prompt)
    caches = {impl: smodel.init_paged_cache(cfg, mb + 1, bs, device="cuda")
              for impl in ("auto", "reference")}
    worst = 0.0
    with torch.inference_mode():
        first = {impl: smodel.paged_prefill(params, c, padded, 40, 0, table,
                                            cfg)[1]
                 for impl, c in caches.items()}
        tok = first["auto"].argmax()[None]
        pos = 40
        for _ in range(16):
            p = torch.tensor([pos], dtype=torch.int32, device="cuda")
            logits = {impl: smodel.paged_decode_step(
                params, c, tok, p, table[None], cfg, attention_impl=impl)[1]
                for impl, c in caches.items()}
            if not torch.isfinite(logits["auto"]).all():
                fail("parity: non-finite logits from the kernel path")
            worst = max(worst, float(
                (logits["auto"] - logits["reference"]).abs().max()))
            tok = logits["auto"].argmax(dim=-1)  # teacher-force the reference
            pos += 1
    say(f"[parity] fp32 GPT-2 small, 16 decode steps: kernel vs plain "
        f"max |logit diff| = {worst:.3e} (atol 1e-3)")
    if worst > 1e-3:
        fail(f"end-to-end logits differ by {worst:.3e} > 1e-3")


# ------------------------------------------------------------------ phase 7


TRAIN_STEPS = 30
TRAIN_REPORT_PERIOD = 5


def write_tokens(workdir, vocab, n_phrases=64, phrase_len=64,
                 n_tokens=1 << 20):
    """A learnable int32 token stream, memmapped: random choices among
    `n_phrases` fixed random phrases (uniform random tokens would sit at
    ln V and show nothing)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    phrases = rng.integers(0, vocab, size=(n_phrases, phrase_len))
    stream = phrases[rng.integers(0, n_phrases, n_tokens // phrase_len)]
    path = os.path.join(workdir, "tokens.int32")
    mm = np.memmap(path, dtype=np.int32, mode="w+", shape=(stream.size,))
    mm[:] = stream.reshape(-1)
    mm.flush()
    del mm
    return path


def train_hparams(workdir):
    """Phase 7's hparams: GPT-2 small, S 1024, B 8, bf16, remat, lr 3e-4,
    on the learnable token stream."""
    return {"model_size": "small", "seq_len": 1024,
            "global_batch_size": 8, "learning_rate": 3e-4,
            "warmup_steps": 5, "decay_steps": 10000, "remat": True,
            "attention_impl": "auto",
            "tokens_path": write_tokens(workdir, 50257)}


def gpt2_trial_class():
    sys.path.insert(0, os.path.join(ROOT, "examples", "gpt2_cuda"))
    from model_def import GPT2Trial

    return GPT2Trial


def phase_train(workdir, hparams):
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    ckpt_dir = os.path.join(workdir, "train_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ctx = core.init(max_length=TRAIN_STEPS, checkpoint_dir=ckpt_dir)
    trial = GPT2Trial(TrialContext(hparams=hparams, core_context=ctx))
    cfg = trial.cfg
    say(f"[train] GPT-2 small: {gpt2.param_count(cfg):,} params, seq_len "
        f"1024, batch 8, {str(cfg.dtype)[6:]}, remat {cfg.remat_policy!r}, "
        f"attention_impl {cfg.attention_impl!r}, {TRAIN_STEPS} steps")
    trainer = Trainer(trial, core_context=ctx)

    # The main path runs from here: every count starts at 0.
    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    fa.reference_attention.calls = 0
    t0 = time.monotonic()
    state = trainer.fit(report_period=TRAIN_REPORT_PERIOD)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dq": fa.flash_dq_cuda.launches,
                "dkv": fa.flash_dkv_cuda.launches}
    ref_calls = fa.reference_attention.calls

    reports = ctx.train.local_training_metrics
    losses = [r["metrics"]["loss"] for r in reports]
    val = ctx.train.local_validation_metrics
    say(f"[train] fit: {state.step} steps in {wall:.1f} s; loss every "
        f"{TRAIN_REPORT_PERIOD} steps: {[round(x, 4) for x in losses]}; "
        f"validation {val[-1]['metrics'] if val else None}")
    if state.step != TRAIN_STEPS or \
            len(losses) != TRAIN_STEPS // TRAIN_REPORT_PERIOD:
        fail(f"fit ran {state.step} steps with {len(losses)} reports")
    if not all(isinstance(x, float) and x == x and abs(x) != float("inf")
               for x in losses):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0] - 0.5:
        fail(f"the loss did not fall: {losses}")
    n_val = sum(1 for _ in trial.build_validation_data())
    eval_graphs = val_shapes(trial)
    captured_fit_step(trainer, reports[0]["metrics"], "[train]")
    want = fit_launches(1, eval_graphs, cfg.n_layer)
    say(f"[train] flash wrapper launches {launches} (expected {want}: the "
        f"warm-up step and the capture, forward 24 a step with the remat "
        f"recompute, + the eval step's warm-up and capture, {cfg.n_layer} "
        f"each, x {eval_graphs} validation batch shape(s) of {n_val} "
        f"batches; the {TRAIN_STEPS - 1} training replays are counted on a "
        f"trace below, the validation replays in 22a); "
        f"reference_attention calls {ref_calls}")
    if launches != want:
        fail(f"flash launches {launches} != {want}")
    if ref_calls != 0:
        fail(f"the plain attention ran {ref_calls} times on the training "
             "path")

    # One COMMITTED checkpoint at the op end, read back bit-identical.
    lineage = ctx.checkpoint.lineage()
    sid = f"trial0-step{TRAIN_STEPS}"
    states = [r["state"] for r in ctx.checkpoint.local_reported]
    if lineage != [sid] or states != ["COMPLETED"] or not os.path.exists(
            os.path.join(ckpt_dir, sid, "COMMIT")):
        fail(f"checkpoints: lineage {lineage}, reports {states}")
    restored = ctx.checkpoint.restore_state(sid, state)
    mu, nu = state.opt_state[1]["mu"], state.opt_state[1]["nu"]
    r_mu, r_nu = restored.opt_state[1]["mu"], restored.opt_state[1]["nu"]
    same = (restored.step == state.step
            and restored.opt_state[1]["count"] == state.opt_state[1]["count"]
            and all(torch.equal(a, b) for a, b in zip(
                restored.leaves() + r_mu + r_nu,
                state.leaves() + mu + nu)))
    say(f"[train] checkpoint {sid}: COMMITTED, restore_state bit-identical "
        f"(params, Adam moments, counts): {same}")
    if not same:
        fail("the restored checkpoint differs from the trained state")
    ctx.close()
    # The step time of fit as it runs: its own `steps_per_second` of each
    # report window (host clock from one flush's device-to-host copy to
    # the next's), summed over every window after the first, which holds
    # the warm-up.
    window_s = [TRAIN_REPORT_PERIOD / r["metrics"]["steps_per_second"]
                for r in reports[1:]]
    n_timed = TRAIN_REPORT_PERIOD * len(window_s)
    step_ms = sum(window_s) / n_timed * 1e3
    breakdown = profile_train_steps(trainer, trial)
    # Which route each flash kernel took on the main path, from the kernel
    # functions the profiler saw: bf16 at D 64 must run all three on the
    # tensor cores.
    routes = {}
    for key in ("fwd", "dq", "dkv"):
        names = [g for g in breakdown["groups"]
                 if g.startswith(f"flash_{key}_")]
        if not names:
            fail(f"the profiler saw no flash {key} kernel in the training "
                 "steps")
        routes[key] = "wgmma" if all("wgmma" in n for n in names) else "ffma"
    say(f"[train] flash kernel routes on the main path: {routes}")
    if any(route != "wgmma" for route in routes.values()):
        fail(f"bf16 at D 64 must run the wgmma kernels, ran {routes}")
    idle = 1.0 - breakdown["busy_ms"] / step_ms
    say(f"[train] fit's step time over steps {TRAIN_REPORT_PERIOD + 1}-"
        f"{TRAIN_STEPS}: {step_ms:.2f} ms a step (report windows "
        f"{[round(w * 1e3 / TRAIN_REPORT_PERIOD, 2) for w in window_s]} ms "
        f"a step); device busy {breakdown['busy_ms']:.2f} ms of it (the "
        f"profiled steps), idle share {idle * 100:.1f}%")
    tokens_per_s = 8 * 1024 / (step_ms / 1e3)
    mfu = gpt2.flops_per_token(cfg, 1024) * tokens_per_s / PEAK_FLOPS[
        "torch.bfloat16"]
    del trainer, state, restored
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms,
            "tokens_per_s": tokens_per_s, "mfu": mfu, "steps": n_timed,
            "idle_share": idle, "breakdown": breakdown, "routes": routes,
            "ckpt_dir": ckpt_dir, "eval_graphs": eval_graphs,
            "losses": {r["steps_completed"]: r["metrics"]["loss"]
                       for r in reports}}


def phase_restored_replica(ckpt_dir, card):
    """A replica restored from `Trainer.fit`'s own checkpoints (phase 7's
    storage): `checkpoint: latest` for the base and one adapter, a second
    committed checkpoint of the trained params whose `wte` is perturbed
    from the seed (trial 1). A newer checkpoint of trial 0 is committed and
    then corrupted first: `latest` must fall back to phase 7's. GPT-2
    small, fp32, 8 slots, max_seq_len 256 (the capture covers 4 buckets).
    Requests for the base and the adapter are answered over HTTP; the
    adapter-routed logits must equal a direct replica of the fine-tune's
    full params within fp32 1e-3 (logits, not tokens)."""
    import numpy as np
    import torch

    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)
    from determined_tpu_torch.serve.http import ServingServer
    from determined_tpu_torch.serve.task import build_replica
    from determined_tpu_torch.train.state import TrainState

    base_ctx = CheckpointContext(ckpt_dir, trial_id=0)
    trained_sid = base_ctx.lineage()[0]
    trained = base_ctx.restore_params(trained_sid)
    gen = torch.Generator().manual_seed(SEED + 8)
    ft = dict(trained)
    ft["wte"] = trained["wte"] + 0.02 * torch.randn(
        trained["wte"].shape, generator=gen)
    ft_sid = CheckpointContext(ckpt_dir, trial_id=1).save_state(
        TrainState(step=TRAIN_STEPS, params=ft, opt_state=None), TRAIN_STEPS)
    bad_sid = base_ctx.save_state(
        TrainState(step=TRAIN_STEPS + 1, params=ft, opt_state=None),
        TRAIN_STEPS + 1)
    victim = os.path.join(ckpt_dir, bad_sid, "state", "state.pt")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    serving = {"model_config": {"model_size": "small", "dtype": "float32"},
               "max_batch_size": 8, "max_seq_len": 256, "kv_block_size": 16,
               "seed": SEED}
    storage = {"type": "shared_fs", "host_path": ckpt_dir}

    # This path runs from here: its counts start at 0.
    paged_attention_cuda.launches = 0
    paged_attention_reference.calls = 0
    engine, batcher = build_replica({
        "serving": {**serving, "checkpoint": "latest",
                    "adapters": [{"name": "ft", "checkpoint": ft_sid}]},
        "checkpoint_storage": storage})
    fell_back = torch.equal(engine.params["wte"].cpu(), trained["wte"])
    say(f"[restore] lineage {base_ctx.lineage()}: the newest, {bad_sid}, "
        f"truncated; `latest` restored {trained_sid}'s params: {fell_back}; "
        f"adapter 'ft' from {ft_sid}")
    if not fell_back:
        fail("checkpoint: latest did not fall back past the corrupt newest "
             "checkpoint")
    batcher.start()
    server = ServingServer(batcher, host="127.0.0.1", port=0).start()
    url = f"http://127.0.0.1:{server.port}/v1/generate"
    rng = np.random.default_rng(SEED + 11)
    vocab = engine.cfg.vocab_size
    try:
        bodies = [{"tokens": rng.integers(0, vocab, 48).tolist(),
                   "max_new_tokens": 32, "model": m}
                  for m in ("base", "ft", "base", "ft")]
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            results = list(pool.map(lambda b: _post(url, b), bodies))
        status, raw = _get(url.replace("/v1/generate", "/v1/stats"))
        stats = json.loads(raw)
    finally:
        server.stop()
        batcher.stop()
    launches = stats["engine"]["attention_launches"]
    ref_calls = paged_attention_reference.calls
    for i, (code, body) in enumerate(results):
        if code != 200 or len(body.get("tokens", [])) != 32:
            fail(f"restored replica, request {i} ({bodies[i]['model']}): "
                 f"HTTP {code} {body}")
    say(f"[restore] [{card}] 4 requests over HTTP answered 200 with 32 "
        f"tokens, routed {stats['adapter_requests']}; decode steps "
        f"{stats['engine']['decode_steps']}, paged launches replayed "
        f"{launches}, reference calls {ref_calls}")
    if stats["adapter_requests"] != {"base": 2, "ft": 2} or launches <= 0 \
            or ref_calls != 0:
        fail(f"restored replica: routing {stats['adapter_requests']}, "
             f"launches {launches}, reference calls {ref_calls}")
    direct, _ = build_replica({
        "serving": {**serving, "checkpoint": ft_sid},
        "checkpoint_storage": storage})
    direct.compile()
    prompt = rng.integers(0, vocab, 40).astype(np.int32)
    logits = {}
    for name, eng, adapter in (("routed", engine, 1), ("direct", direct, 0)):
        out = [eng.prefill_logits(0, prompt, adapter=adapter).clone()]
        tokens = np.zeros((eng.slots,), np.int32)
        positions = np.zeros((eng.slots,), np.int32)
        for step in range(16):
            # The direct replica is fed the routed run's tokens.
            tokens[0] = int((logits["routed"][step] if name == "direct"
                             else out[-1]).argmax())
            positions[0] = len(prompt) + step
            out.append(eng.decode_logits(tokens, positions)[0].clone())
        logits[name] = out
    worst = max_diff(logits["routed"], logits["direct"])
    base_gap = float((logits["routed"][0] - engine.prefill_logits(
        1, prompt).float()).abs().max())
    say(f"[restore] [{card}] fp32, adapter-routed vs a direct replica of the "
        f"fine-tune, prefill + 16 decode steps (the direct one fed the "
        f"routed tokens): max |logit diff| {worst:.3e} (atol 1e-3); the "
        f"adapter moves the prefill logits from the base's by {base_gap:.3f}")
    if worst > 1e-3 or base_gap < 1e-2:
        fail(f"adapter routing: max |logit diff| {worst:.3e} against a direct "
             f"replica, {base_gap:.3e} against the base")
    del engine, batcher, direct
    _free_cuda()
    replica_drains_on_preemption(
        {**serving, "checkpoint": "latest",
         "adapters": [{"name": "ft", "checkpoint": ft_sid}]}, storage, card)


# ------------------------------------------------------------ phase 7c / 7d


class FakeMaster:
    """An in-process stdlib master speaking the endpoints a managed trial
    and a serve replica call, every request recorded as (method, path,
    query, body). The searcher hands out one op of `length`, then `done`;
    COMPLETED checkpoint reports go into a registry that the lineage
    query returns, newest first. The preemption long-poll is held until
    `arm()` (or, with `preempt_after`, until the training report of that
    step has arrived: that report's answer waits until the signal is out,
    so the trial sees it at that step's poll)."""

    def __init__(self, length=0, preempt_after=None, deadline_s=120):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.requests = []
        self.registry = []
        self.length = length
        self.preempt_after = preempt_after
        self.deadline_s = deadline_s
        self._armed = threading.Event()
        self._sent = threading.Event()
        self._closed = threading.Event()
        master = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _answer(self):
                url = urllib.parse.urlsplit(self.path)
                query = dict(urllib.parse.parse_qsl(url.query))
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n)) if n else None
                out = master.answer(self.command, url.path, query, body)
                data = json.dumps(out).encode()
                try:
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    return  # the client left: a process exited mid-poll
                if out.get("preempt"):
                    master._sent.set()

            do_GET = do_POST = _answer

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def arm(self):
        self._armed.set()

    def answer(self, method, path, query, body):
        if path.endswith("/signals/preemption"):
            end = time.monotonic() + float(query.get("timeout_seconds", 60))
            while not (self._armed.is_set() or self._closed.is_set()) and \
                    time.monotonic() < end:
                self._armed.wait(0.05)
            if self._armed.is_set():
                return {"preempt": True, "deadline_seconds": self.deadline_s,
                        "reason": "chip_smoke"}
            time.sleep(0.05)
            return {}
        self.requests.append((method, path, query, body))
        if path.endswith("/searcher/operation"):
            return ({"done": True} if int(query["last"]) >= self.length
                    else {"op": {"length": self.length}})
        if path == "/api/v1/checkpoints" and body["state"] == "COMPLETED":
            self.registry.insert(0, body["uuid"])
        if path.endswith("/checkpoints"):
            return {"checkpoints": [{"uuid": u} for u in self.registry]}
        if path.endswith("/metrics") and body["group"] == "training" and \
                body["steps_completed"] == self.preempt_after and \
                not self._armed.is_set():
            self.arm()
            if not self._sent.wait(30):
                fail("the trial never long-polled for preemption")
            time.sleep(0.2)  # the watcher takes the signal in
        return {}

    def posted(self, suffix):
        return [b for m, p, q, b in self.requests
                if m == "POST" and p.endswith(suffix)]

    def release(self):
        """Answer held long-polls at once, so a closing watcher exits."""
        self._closed.set()

    def close(self):
        self.release()
        self._server.shutdown()
        self._server.server_close()


class cluster_env:
    """The `DET_*` variables an agent sets, for the `with` block only."""

    def __init__(self, **env):
        self._env = env

    def __enter__(self):
        self._saved = {k: os.environ.get(k) for k in self._env}
        os.environ.update(self._env)

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def state_tensors(state):
    from determined_tpu_torch.core._checkpoint import _map_tensors

    out = []
    _map_tensors(state, out.append)
    return out


MANAGED_TRIAL = 1
MANAGED_PREEMPT_AT = 15


def phase_managed_trial(workdir, hparams, train, card):
    """GPT-2 small trained as a cluster trial against an in-process fake
    master: `core.init()` reads the `DET_*` environment, the prefetcher
    and async checkpoints are on. Run A is preempted (deadline 120 s)
    after the report of step 15 and must ack, save, commit and register
    trial1-step15 and return there; its losses at 5, 10 and 15 are held
    to phase 7's. Run B, a fresh `core.init()` with
    `DET_LATEST_CHECKPOINT`, restores A's state bitwise, trains to 30,
    commits trial1-step30 and completes the op; the searcher then says
    `done`."""
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    storage = os.path.join(workdir, "managed_checkpoints")
    shutil.rmtree(storage, ignore_errors=True)
    sid = f"trial{MANAGED_TRIAL}-step{MANAGED_PREEMPT_AT}"
    base_env = {
        "DET_TRIAL_ID": str(MANAGED_TRIAL), "DET_EXPERIMENT_ID": "1",
        "DET_ALLOCATION_ID": "smoke-alloc", "DET_SESSION_TOKEN": "smoke",
        "DET_HPARAMS": json.dumps(hparams),
        "DET_EXPERIMENT_CONFIG": json.dumps({"checkpoint_storage": {
            "type": "shared_fs", "host_path": storage}})}

    def run(master, **extra):
        with cluster_env(DET_MASTER=master.url, **base_env, **extra):
            ctx = core.init()
            if ctx.info is None or ctx.checkpoint._session is None:
                fail("core.init() did not take the cluster environment")
            trainer = Trainer(GPT2Trial(TrialContext(
                hparams=ctx.hparams, core_context=ctx)), core_context=ctx)
            return ctx, trainer

    # This path runs from here: its counts start at 0.
    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    fa.reference_attention.calls = 0
    master_a = FakeMaster(TRAIN_STEPS, preempt_after=MANAGED_PREEMPT_AT)
    t0 = time.monotonic()
    try:
        ctx, trainer = run(master_a)
        state_a = trainer.fit(report_period=TRAIN_REPORT_PERIOD,
                              preempt_period=TRAIN_REPORT_PERIOD)
        ctx.train.report_progress(state_a.step / TRAIN_STEPS)
        master_a.release()
        ctx.close()
    finally:
        master_a.close()
    wall_a = time.monotonic() - t0
    ckpts_a = [(c["uuid"], c["state"])
               for c in master_a.posted("/api/v1/checkpoints")]
    say(f"[managed] run A: fit returned at step {state_a.step} in "
        f"{wall_a:.1f} s; preemption acked "
        f"{len(master_a.posted('/signals/ack_preemption'))}x; checkpoint "
        f"reports {ckpts_a}; registry {master_a.registry}")
    if state_a.step != MANAGED_PREEMPT_AT or ckpts_a != [
            (sid, "PARTIAL"), (sid, "COMPLETED")] or \
            master_a.registry != [sid] or \
            not master_a.posted("/signals/ack_preemption") or \
            master_a.posted("/searcher/completed_operation"):
        fail("run A did not stop at the preemption with a committed, "
             "registered checkpoint")
    reports_a = [b for b in master_a.posted("/metrics")
                 if b["group"] == "training" and "loss" in b["metrics"]]
    worst = 0.0
    for r in reports_a:
        step = r["steps_completed"]
        diff = abs(r["metrics"]["loss"] - train["losses"][step])
        worst = max(worst, diff)
        say(f"[managed] run A step {step}: loss {r['metrics']['loss']:.6f}, "
            f"phase 7 {train['losses'][step]:.6f}, |diff| {diff:.3e}")
    say(f"[managed] run A losses against phase 7's: max |diff| {worst:.3e} "
        f"(tolerance 1e-5; bitwise equal: {worst == 0.0})")
    if [r["steps_completed"] for r in reports_a] != [5, 10, 15] or \
            worst > 1e-5:
        fail(f"run A's losses differ from phase 7's by {worst:.3e}")

    master_b = FakeMaster(TRAIN_STEPS)
    t0 = time.monotonic()
    try:
        ctx, trainer = run(master_b, DET_LATEST_CHECKPOINT=sid)
        if ctx.latest_checkpoint != sid:
            fail(f"DET_LATEST_CHECKPOINT read as {ctx.latest_checkpoint}")
        restored = ctx.checkpoint.restore_state(sid, state_a)
        got, want = state_tensors(restored), state_tensors(state_a)
        same = len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
        say(f"[managed] run B: {sid} restored bitwise equal to run A's "
            f"final state ({len(got)} tensors: params and Adam moments): "
            f"{same}")
        if not same:
            fail("the registered checkpoint differs from run A's state")
        del restored, got, want
        state_b = trainer.fit(report_period=TRAIN_REPORT_PERIOD,
                              preempt_period=TRAIN_REPORT_PERIOD)
        ctx.train.report_progress(state_b.step / TRAIN_STEPS)
        master_b.release()
        ctx.close()
    finally:
        master_b.close()
    torch.cuda.synchronize()
    wall_b = time.monotonic() - t0
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dq": fa.flash_dq_cuda.launches,
                "dkv": fa.flash_dkv_cuda.launches}
    ref_calls = fa.reference_attention.calls
    end = f"trial{MANAGED_TRIAL}-step{TRAIN_STEPS}"
    ckpts_b = [(c["uuid"], c["state"])
               for c in master_b.posted("/api/v1/checkpoints")]
    ops = master_b.posted("/searcher/completed_operation")
    polls = [q["last"] for m, p, q, b in master_b.requests
             if p.endswith("/searcher/operation")]
    say(f"[managed] run B: fit returned at step {state_b.step} in "
        f"{wall_b:.1f} s; checkpoint reports {ckpts_b}; completed op {ops}; "
        f"searcher polls last={polls}")
    if state_b.step != TRAIN_STEPS or ckpts_b != [
            (end, "PARTIAL"), (end, "COMPLETED")] or len(ops) != 1 or \
            ops[0]["length"] != TRAIN_STEPS or polls != ["0", "30"]:
        fail("run B did not resume, finish the op and stop at done")

    record = master_a.requests + master_b.requests
    steps = sorted(b["steps_completed"] for b in master_a.posted("/metrics")
                   + master_b.posted("/metrics")
                   if b["group"] == "training" and "loss" in b["metrics"])
    counts = {name: sum(1 for m, p, q, b in record if p.endswith(name))
              for name in ("/run_prepare", "/spans", "/progress",
                           "/ack_preemption")}
    completed = [u for u in master_a.registry + master_b.registry]
    say(f"[managed] the master's record: {len(record)} requests; training "
        f"reports at steps {steps}; COMPLETED checkpoints {completed}; "
        f"{counts}; validation reports "
        f"{[b['steps_completed'] for b in master_b.posted('/metrics') if b['group'] == 'validation']}")
    if steps != list(range(5, 31, 5)) or len(completed) != 2 or \
            counts["/run_prepare"] != 2 or counts["/spans"] == 0 or \
            counts["/progress"] != 2 or counts["/ack_preemption"] != 1:
        fail(f"the master's record is incomplete: {steps} {counts}")
    n_layer = trainer.trial.cfg.n_layer
    # Runs A and B each capture their step once; B validates at the end,
    # capturing its eval step.
    want = fit_launches(2, train["eval_graphs"], n_layer)
    say(f"[managed] flash wrapper launches over runs A and B {launches} "
        f"(expected {want}: each run's warm-up step and capture, and the "
        f"validation); reference_attention calls {ref_calls}")
    if launches != want or ref_calls != 0:
        fail(f"managed trial: flash launches {launches} != {want} or plain "
             f"attention calls {ref_calls}")
    for name, master in (("A", master_a), ("B", master_b)):
        for b in master.posted("/metrics"):
            m = b["metrics"]
            if b["group"] == "training" and "input_wait_ms" in m:
                say(f"[managed] [{card}] run {name} window to step "
                    f"{b['steps_completed']}: "
                    f"{1e3 / m['steps_per_second']:.2f} ms a step, "
                    f"input_wait_ms {m['input_wait_ms']:.4f}, h2d_ms "
                    f"{m['h2d_ms']:.4f}, prefetch_queue_depth "
                    f"{m['prefetch_queue_depth']:.2f}")
    del trainer, state_a, state_b
    _free_cuda()
    return launches


def _span_ms(spans, name, storage_id):
    return sum((s["end_us"] - s["start_us"]) / 1e3 for s in spans
               if s["name"] == name
               and s["attrs"].get("storage_id") == storage_id)


def phase_prefetch_pairs(workdir, hparams, card):
    """Information, not a claim: 15-step fits of phase 7's trial in local
    mode with the prefetcher off and on in turns (off, on, on, off), a
    periodic async checkpoint at step 10 (its write overlaps steps 11-15),
    and fit's step per report window; then the blocking cost of that
    async save (the part save_state paid plus the wait that committed it,
    from the checkpoint spans) against a synchronous save of the same
    state (`async_save` off)."""
    import shutil

    from determined_tpu_torch import core
    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    ckpt_dir = os.path.join(workdir, "pair_checkpoints")
    rows = []
    for i, mode in enumerate(("off", "on", "on", "off")):
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        ctx = core.init(max_length=15, checkpoint_dir=ckpt_dir)
        trial = GPT2Trial(TrialContext(hparams=hparams, core_context=ctx))
        trial.prefetch = mode == "on"
        state = Trainer(trial, core_context=ctx).fit(
            report_period=TRAIN_REPORT_PERIOD, checkpoint_period=10)
        ctx.close()
        reports = ctx.train.local_training_metrics
        windows = [1e3 / r["metrics"]["steps_per_second"] for r in reports]
        spans = ctx.tracer.local_spans
        sid = "trial0-step10"
        save_ms = _span_ms(spans, "harness.checkpoint.save", sid)
        commit_ms = _span_ms(spans, "harness.checkpoint.commit", sid)
        rows.append((mode, windows, save_ms, commit_ms, reports[-1]))
        say(f"[pairs] [{card}] #{i + 1} prefetch {mode}: fit's step by "
            f"window (1-5, 6-10, 11-15 with the step-10 write in flight) "
            f"{[round(w, 2) for w in windows]} ms; async save of step 10: "
            f"{save_ms:.1f} ms in save_state + {commit_ms:.1f} ms blocked "
            f"in the wait that committed it")
        if len(windows) != 3:
            fail(f"prefetch pair {i + 1}: {len(windows)} report windows")
        last_state = state
    sync = CheckpointContext(os.path.join(workdir, "sync_checkpoint"),
                             async_save=False)
    sync.save_state(last_state, 15)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shutil.rmtree(os.path.join(workdir, "sync_checkpoint"),
                  ignore_errors=True)
    async_ms = statistics.median(r[2] + r[3] for r in rows)
    size_gb = sum(t.numel() * t.element_size()
                  for t in state_tensors(last_state)) / 1e9
    say(f"[pairs] [{card}] checkpoint of GPT-2 small's train state "
        f"({size_gb:.3f} GB): synchronous last_save_ms "
        f"{sync.last_save_ms:.1f}; async, the loop blocked {async_ms:.1f} "
        f"ms (median of 4)")
    sync_ms = sync.last_save_ms
    del last_state, state, sync
    _free_cuda()
    return {"rows": rows, "sync_ms": sync_ms, "async_ms": async_ms}


REPLICA_PROMPT, REPLICA_NEW_TOKENS = 48, 200


def replica_drains_on_preemption(serving, storage, card):
    """The replica as a cluster runs it (`python -m
    determined_tpu_torch.serve`, a process of its own) attached to a fake
    master: with requests in flight the master answers the allocation's
    preemption long-poll; the replica must ack, report draining, finish
    every accepted request and exit 0."""
    import numpy as np

    from determined_tpu_torch.serve.task import build_model

    vocab = build_model(serving).vocab_size
    master = FakeMaster()
    env = dict(os.environ, PYTHONPATH=ROOT, DET_MASTER=master.url,
               DET_ALLOCATION_ID="smoke-replica",
               DET_SERVING_CONFIG=json.dumps({
                   "serving": {**serving, "heartbeat_period_s": 30},
                   "checkpoint_storage": storage}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "determined_tpu_torch.serve"], cwd=ROOT,
        env=env, stderr=subprocess.PIPE, text=True)
    lines, up = [], threading.Event()

    def read_stderr():
        for line in proc.stderr:
            lines.append(line)
            if "serve replica up on port" in line:
                up.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        if not up.wait(600):
            fail("the replica process never came up: "
                 + "".join(lines[-20:]))
        port = int(re.search(r"serve replica up on port (\d+)",
                             [x for x in lines if "up on port" in x][0])
                   .group(1))
        url = f"http://127.0.0.1:{port}"
        rng = np.random.default_rng(SEED + 12)
        bodies = [{"tokens": rng.integers(0, vocab, REPLICA_PROMPT).tolist(),
                   "max_new_tokens": REPLICA_NEW_TOKENS, "model": m}
                  for m in ("base", "ft", "base", "ft")]
        pool = concurrent.futures.ThreadPoolExecutor(len(bodies))
        futures = [pool.submit(_post, url + "/v1/generate", b)
                   for b in bodies]
        deadline = time.monotonic() + 120
        while True:
            stats = json.loads(_get(url + "/v1/stats")[1])
            if stats["active"] + stats["completed"] == len(bodies):
                break
            if time.monotonic() > deadline:
                fail(f"the replica never admitted the requests: {stats}")
            time.sleep(0.02)
        in_flight = stats["active"]
        t0 = time.monotonic()
        master.arm()
        rc = proc.wait(timeout=300)
        drain_s = time.monotonic() - t0
        results = [f.result(timeout=60) for f in futures]
        pool.shutdown()
    finally:
        master.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=30)
    est = stats["engine"]
    acks = master.posted("/signals/ack_preemption")
    beats = master.posted("/serve_stats")
    say(f"[restore] [{card}] replica process: {len(bodies)} requests "
        f"accepted, {in_flight} in flight when the master sent the "
        f"preemption; exit code {rc} {drain_s:.2f} s later; answers "
        f"{[(c, len(b.get('tokens', []))) for c, b in results]}; acked "
        f"{len(acks)}x, last heartbeat draining="
        f"{beats[-1]['draining'] if beats else None}; paged launches "
        f"replayed before the drain {est['attention_launches']}, reference "
        f"calls {est['attention_reference_calls']}")
    if rc != 0 or not acks or not beats or not beats[-1]["draining"] or \
            any(c != 200 or len(b.get("tokens", [])) != REPLICA_NEW_TOKENS
                for c, b in results) or est["attention_launches"] <= 0 or \
            est["attention_reference_calls"] != 0:
        fail("the replica did not drain cleanly on the preemption signal: "
             + "".join(lines[-20:]))


def fit_launches(captures, eval_graphs, n_layer):
    """The flash wrappers' counts over fits on one card whose step was
    captured `captures` times (a graph a batch shape, a fit): each
    capture's warm-up step and its recording call the wrappers (the
    forward twice a layer with the remat recompute, dQ and dK/dV once);
    the replays do not (a trace counts their launches); plus the eval
    step's `eval_graphs` captures (a graph a validation batch shape, a
    fit), each a warm-up and a recording of one forward a layer (its
    replays are counted on a trace, 22a)."""
    steps = 2 * captures
    return {"fwd": (2 * steps + 2 * eval_graphs) * n_layer,
            "dq": steps * n_layer, "dkv": steps * n_layer}


def val_shapes(trial):
    """How many batch shapes the trial's validation data has: the eval
    graphs one fit captures."""
    import numpy as np

    return len({tuple(np.shape(v) for v in batch.values())
                for batch in trial.build_validation_data()})


def captured_fit_step(trainer, flush, where, graphs=1):
    """The step a one-card `fit` ran, checked: `make_captured_step`'s, with
    `graphs` graphs (batch shapes), and the first metrics flush reporting
    `step_captured` 1.0. -> the step."""
    from determined_tpu_torch.train.step import _CapturedStep

    step = trainer._train_step
    n = len(step.graphs) if isinstance(step, _CapturedStep) else None
    say(f"{where} fit's step: {type(step).__name__} with {n} graph(s); the "
        f"first flush: step_captured {flush.get('step_captured')}, "
        f"step_route {flush.get('step_route')!r}")
    if n != graphs or flush.get("step_captured") != 1.0:
        fail(f"{where} fit did not replay its step as {graphs} captured "
             "graph(s)")
    return step


def fit_rng(step):
    """The generator a captured fit step registered with its graphs (its
    replays draw from that one only); a new one for an eager step."""
    import torch

    graphs = list(getattr(step, "graphs", {}).values())
    if graphs:
        return graphs[0].rng
    return torch.Generator(device="cuda").manual_seed(SEED)


# Spin kernels (count, cycles each) before and after a traced window. Late
# in this script's process a trace loses the device events of its first
# ~10 ms (seen on the card: 16 pads of ~0.5 ms were not enough, and the
# window's first ~1.2 ms went with them, its first flash forward among
# them; in a fresh process nothing is lost): the pads, ~60 ms in 4096
# kernels, take that loss, and the readers leave them out.
TRACE_PAD = (4096, 30_000)
PAD_KERNEL = "spin_kernel"


def trace_pad():
    import torch

    for _ in range(TRACE_PAD[0]):
        torch.cuda._sleep(TRACE_PAD[1])
    torch.cuda.synchronize()


def device_events(prof, pads=False):
    """The device events of a trace, the pads' spin kernels left out (or,
    with `pads`, only those)."""
    return [ev for ev in prof.events()
            if str(getattr(ev, "device_type", "")).split(".")[-1] == "CUDA"
            and (PAD_KERNEL in ev.name) == pads]


def flash_events(prof):
    """The flash kernels' launches on a torch.profiler trace, by kernel."""
    counts = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for ev in device_events(prof):
        hit = FLASH_KERNEL_NAME.search(ev.name)
        if hit:
            counts["flash_" + hit.group(1)] += 1
    return counts


def profile_train_steps(trainer, trial, n_steps=3):
    """Device time of `n_steps` more training steps by kernel group, under
    torch.profiler (one stream: kernels do not overlap, so their sum is
    the busy time), and the flash kernels counted on the trace: a fit
    step replayed on one card must launch its graph's count each step.
    The profiler slows the host, so the wall time and idle share of
    these steps are the profiled loop's, not fit's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from determined_tpu_torch.train.trainer import _to_device

    data = iter(trial.build_training_data())
    batches = [_to_device(next(data), trainer.device) for _ in range(n_steps)]
    step = trainer._train_step
    rng = fit_rng(step)
    state = step(trainer.state, batches[0], rng)[0]  # warm, unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace_pad()
        t0 = time.perf_counter()
        for batch in batches:
            state = step(state, batch, rng)[0]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        trace_pad()
    # One group per flash kernel function (its name and template
    # arguments, so the route that ran shows), then GEMMs and the rest.
    groups = {"gemm": 0.0, "other": 0.0}
    per_kernel = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0 or PAD_KERNEL in ev.key:
            continue
        name = ev.key
        per_kernel[name] = per_kernel.get(name, 0.0) + us / 1e3
        flash = re.search(r"flash_\w+_kernel(<[^>]*>)?", name)
        if flash:
            groups[flash.group(0)] = groups.get(flash.group(0), 0.0) + us / 1e3
        elif "gemm" in name.lower() or "sm90_xmma" in name or \
                "cutlass" in name.lower():
            groups["gemm"] += us / 1e3
        else:
            groups["other"] += us / 1e3
    busy = sum(groups.values())
    out = {"groups": {k: v / n_steps for k, v in groups.items()}}
    out["busy_ms"] = busy / n_steps
    out["wall_ms"] = wall_ms / n_steps
    out["idle_share"] = 1.0 - busy / wall_ms
    out["flash"] = flash_events(prof)
    graphs = list(getattr(step, "graphs", {}).values())
    if graphs:
        want = {k: v * n_steps for k, v in graphs[0].launches.items()}
        say(f"[profile] flash kernels traced in {n_steps} replayed steps "
            f"{out['flash']} (the graph's {graphs[0].launches} x {n_steps})")
        if out["flash"] != want:
            fail(f"the replayed steps launched {out['flash']} flash kernels, "
                 f"not the graph's {want}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    say(f"[profile] {n_steps} training steps under torch.profiler: wall "
        f"{out['wall_ms']:.2f} ms a step (the profiled loop), device busy "
        f"{out['busy_ms']:.2f} ms, idle share under the profiler "
        f"{out['idle_share'] * 100:.1f}%; device ms a step by group: "
        + ", ".join(f"{k} {v:.2f}" for k, v in out["groups"].items()))
    for name, ms in top:
        say(f"[profile]   {ms / n_steps:8.3f} ms/step  {name[:110]}")
    return out


# ------------------------------------------------------------ phase 8a-8c


MULTI_STEPS = 4      # steps_per_call of 8a
MULTI_WINDOWS = 2    # the first captures, the second only replays
# 8a's limits, eager against replayed steps from the same state: the
# window-mean loss, grad_norm and all_finite rtol 1e-6, params atol 1e-6.
# The replay holds the eager step's kernels in the eager step's order,
# fed the same optimizer floats (as a device tensor both ways), so the
# two are expected bitwise equal; a calibration run found them so
# (`make_train_step` and the replays, GPT-2 small bf16 and 2 layers fp32).
MULTI_RTOL, MULTI_PARAM_ATOL = 1e-6, 1e-6


def example_tx():
    """The example trial's optimizer chain at phase 7's hparams."""
    from determined_tpu_torch.train import optim

    return optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(
        optim.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 10000), b2=0.95,
        weight_decay=0.1))


def token_windows(tokens_path, n_windows, steps, b=8, s=1024, seed=SEED + 21):
    """`n_windows` stacks of `steps` batches [steps, b, s+1] from the token
    stream, on the card."""
    import numpy as np
    import torch

    stream = np.memmap(tokens_path, dtype=np.int32, mode="r")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        starts = rng.integers(0, len(stream) - s - 1, (steps, b))
        win = np.stack([[stream[i:i + s + 1] for i in row] for row in starts])
        out.append(torch.from_numpy(win.astype(np.int32)).cuda())
    return out


def device_ms_per_step(run, n_steps):
    """Kernel time a step of `run()` (n_steps steps) under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    busy = 0.0
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        busy += max(0.0, us) / 1e3
    return busy / n_steps


FLASH_KERNEL_NAME = re.compile(r"flash_(fwd|dq|dkv)_(wgmma_)?kernel")


def union_ms(spans):
    """ms covered by the union of the (start, end) intervals `spans`
    (microseconds): time in which one kernel or more ran, however many
    streams ran at once."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def device_trace(run, n_steps):
    """`run()` (n_steps steps) traced under torch.profiler, from the
    device events on the trace's timeline: {"busy_ms": the union of every
    kernel's and copy's interval a step, "nccl_ms": the union of the NCCL
    kernels' a step, "nccl_only_ms": NCCL time a step during which no
    other device work ran, "wall_ms": host ms a step around the traced
    run, "idle": 1 - busy / wall, "flash": the flash kernels' launches by
    kernel (`flash_fwd` ...)}. NCCL kernels that wait for a peer count as
    busy: the card holds them. The window sits between two `trace_pad`s,
    left out of every reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace_pad()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        trace_pad()
    spans, nccl, other = [], [], []
    for ev in device_events(prof):
        span = (ev.time_range.start, ev.time_range.end)
        spans.append(span)
        (nccl if "nccl" in ev.name.lower() else other).append(span)
    busy = union_ms(spans)
    return {"busy_ms": busy / n_steps, "nccl_ms": union_ms(nccl) / n_steps,
            "nccl_only_ms": (busy - union_ms(other)) / n_steps,
            "wall_ms": wall / n_steps, "idle": 1 - busy / wall,
            "flash": flash_events(prof),
            "pads": len(device_events(prof, pads=True))}


def step_order_sum(values):
    """fp32 sum in step order, ((m0 + m1) + m2) + m3, as the replays
    accumulate their metrics."""
    total = values[0].float()
    for v in values[1:]:
        total = total + v.float()
    return total


def replay_against_eager(cfg, hparams, seed):
    """`make_multi_step` (steps_per_call MULTI_STEPS) over MULTI_WINDOWS
    windows of the token stream, and as many `make_train_step` calls, each
    from a state initialised from `seed` (windows from seed + 1, the rng
    seed + 2). Every count starts at 0 before the replayed run. Returns
    the multi step, the train step, both states, their window-mean
    metrics (the eager ones summed in the replays' order), the flash
    wrappers' counts over the replayed run, the plain attention's calls,
    the windows and the rng."""
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train.state import create_train_state
    from determined_tpu_torch.train.step import make_multi_step, make_train_step

    def loss(p, b, r):
        return gpt2.loss_fn(p, b, cfg)

    def state_of(tx):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return create_train_state(lambda g: gpt2.init(g, cfg), tx, gen,
                                  device="cuda")

    windows = token_windows(hparams["tokens_path"], MULTI_WINDOWS,
                            MULTI_STEPS, seed=seed + 1)
    tx_r, tx_e = example_tx(), example_tx()
    multi = make_multi_step(loss, tx_r, steps_per_call=MULTI_STEPS)
    step = make_train_step(loss, tx_e)
    rng = torch.Generator(device="cuda").manual_seed(seed + 2)

    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    fa.reference_attention.calls = 0
    replayed = state_of(tx_r)
    means_r = []
    for w in windows:
        replayed, m = multi(replayed, {"tokens": w}, rng)
        means_r.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    wrapper = {"fwd": fa.flash_fwd_cuda.launches,
               "dq": fa.flash_dq_cuda.launches,
               "dkv": fa.flash_dkv_cuda.launches}
    ref_calls = fa.reference_attention.calls
    eager = state_of(tx_e)
    means_e = []
    for w in windows:
        ms = []
        for i in range(MULTI_STEPS):
            eager, m = step(eager, {"tokens": w[i]}, rng)
            ms.append(m)
        means_e.append({k: float(step_order_sum([x[k] for x in ms])
                                 / MULTI_STEPS) for k in ms[0]})
    torch.cuda.synchronize()
    return {"multi": multi, "step": step, "replayed": replayed,
            "eager": eager, "means_r": means_r, "means_e": means_e,
            "wrapper": wrapper, "ref_calls": ref_calls, "windows": windows,
            "rng": rng}


def phase_multi_step(hparams, card, depth=12):
    """8a: `make_multi_step` (steps_per_call 4) against 4 `make_train_step`
    calls from the same state and batches, GPT-2 small at full width, B 8,
    S 1024, bf16, remat "dots": the first window runs step 0 eagerly and
    captures the step, the second only replays. Window-mean losses and
    grad norms and the params after both windows are held to the eager
    run's (MULTI_RTOL, MULTI_PARAM_ATOL); whether they are bitwise equal is
    printed. The flash kernels must have run inside the replays (the
    launches the captured step holds, times the replays). Then, as
    information: the step time replayed and eager in turns (replay,
    eager, eager, replay), host clock over a window, and torch.profiler's
    device time a step of each."""
    import dataclasses

    import torch

    from determined_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.Config.small(), n_layer=depth)
    # The main path of 8a: every count starts at 0 in the helper.
    run = replay_against_eager(cfg, hparams, SEED + 20)
    multi, step, rng = run["multi"], run["step"], run["rng"]
    replayed, eager = run["replayed"], run["eager"]
    means_r, means_e = run["means_r"], run["means_e"]
    wrapper, ref_calls, windows = run["wrapper"], run["ref_calls"], \
        run["windows"]
    in_replays = dict(multi.replayed_launches)
    L = cfg.n_layer
    replays = MULTI_STEPS * MULTI_WINDOWS - 1
    want_graph = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}
    say(f"[multi] [{card}] GPT-2 small width, {L} layers, B 8, S 1024, bf16, "
        f"remat 'dots': make_multi_step(steps_per_call={MULTI_STEPS}) x "
        f"{MULTI_WINDOWS} windows = 1 eager warm-up step + {replays} "
        f"replays ({multi.replays}); the captured step holds "
        f"{multi._graph_launches} flash launches (expected {want_graph}); "
        f"launched inside the replays {in_replays}; the wrappers' own "
        f"counts (warm-up + capture) {wrapper}; reference calls "
        f"{ref_calls}")
    if multi.replays != replays or multi._graph_launches != want_graph or \
            in_replays != {k: v * replays for k, v in want_graph.items()} \
            or ref_calls:
        fail("the flash kernels did not run inside the multi-step replays")
    worst_rel = 0.0
    for mr, me in zip(means_r, means_e):
        for k in ("loss", "grad_norm", "all_finite"):
            worst_rel = max(worst_rel, abs(mr[k] - me[k]) / max(abs(me[k]),
                                                               1e-12))
    flat_r = gpt2._flatten(replayed.params)
    flat_e = gpt2._flatten(eager.params)
    worst_p, worst_name = 0.0, ""
    for name in flat_e:
        d = float((flat_r[name] - flat_e[name]).detach().abs().max())
        if d > worst_p:
            worst_p, worst_name = d, name
    bitwise = worst_p == 0.0 and all(
        mr[k] == me[k] for mr, me in zip(means_r, means_e) for k in mr)
    say(f"[multi] [{card}] replayed vs eager, {MULTI_STEPS * MULTI_WINDOWS} "
        f"steps: window-mean losses {[m['loss'] for m in means_r]} vs "
        f"{[m['loss'] for m in means_e]}, max rel diff of loss / grad_norm / "
        f"all_finite {worst_rel:.3e} (rtol {MULTI_RTOL}); max |param diff| "
        f"{worst_p:.3e} ({worst_name or 'none'}; atol {MULTI_PARAM_ATOL}); "
        f"bitwise equal: {bitwise}")
    if worst_rel > MULTI_RTOL or worst_p > MULTI_PARAM_ATOL:
        fail("make_multi_step's replays differ from make_train_step's steps")

    # Information: the step replayed against eager, in turns.
    w = windows[0]

    def run_replay():
        multi(replayed, {"tokens": w}, rng)

    def run_eager():
        for i in range(MULTI_STEPS):
            step(eager, {"tokens": w[i]}, rng)

    host = {"replay": [], "eager": []}
    for mode in ("replay", "eager", "eager", "replay"):
        fn = run_replay if mode == "replay" else run_eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host[mode].append((time.perf_counter() - t0) * 1e3 / MULTI_STEPS)
    dev = {"replay": device_ms_per_step(run_replay, MULTI_STEPS),
           "eager": device_ms_per_step(run_eager, MULTI_STEPS)}
    for mode in ("replay", "eager"):
        say(f"[multi] [{card}] {mode}: host {host[mode][0]:.2f} / "
            f"{host[mode][1]:.2f} ms a step (two windows of {MULTI_STEPS}, "
            f"in turns), device {dev[mode]:.2f} ms a step (torch.profiler), "
            f"idle share {max(0.0, 1 - dev[mode] / min(host[mode])) * 100:.1f}"
            f"% of the faster window")
    del replayed, eager, multi, run
    _free_cuda()
    return {"host": host, "device": dev, "bitwise": bitwise}


REMAT_POLICY_NAMES = (None, "nothing", "dots", "dots_saveable", "everything")
# 8b's limits against "dots": the forward is the same arithmetic under
# every policy (loss rtol 1e-6); the backward differs only in what it
# recomputes with the same kernels (grad_norm rtol 1e-4).
REMAT_LOSS_RTOL, REMAT_NORM_RTOL = 1e-6, 1e-4


def phase_remat_policies(card, depth=2):
    """8b: the five remat policies at full width and 2 layers (B 8, S 1024,
    bf16): loss and grad norm of one forward and backward, held to
    "dots"'s, with the peak memory of each and its flash forward launches
    (two a layer when the recompute runs the kernel again, one under
    "everything")."""
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import optim

    base = dataclasses.replace(gpt2.Config.small(), n_layer=depth)
    params = gpt2.init(torch.Generator(device="cuda").manual_seed(SEED + 23),
                       base)
    rng = np.random.default_rng(SEED + 24)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, base.vocab_size, (8, 1025)).astype(np.int32)).cuda()}
    leaves = list(gpt2._flatten(params).values())
    for t in leaves:
        t.requires_grad_(True)
    out = {}
    for policy in REMAT_POLICY_NAMES:
        cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fa.flash_fwd_cuda.launches = 0
        loss = gpt2.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        norm = float(optim.global_norm(grads))
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        out[policy] = (float(loss.detach()), norm, peak,
                       fa.flash_fwd_cuda.launches)
        del loss, grads
    ref_loss, ref_norm = out["dots"][:2]
    for policy, (loss, norm, peak, fwd) in out.items():
        want_fwd = depth * (1 if policy == "everything" else 2)
        say(f"[remat] [{card}] {str(policy):13s} loss {loss:.6f} grad_norm "
            f"{norm:.6f} (vs dots: loss {loss - ref_loss:+.2e}, grad_norm "
            f"rel {(norm - ref_norm) / ref_norm:+.2e}); peak memory above "
            f"the params {peak:.3f} GiB; flash forward launches {fwd} "
            f"(expected {want_fwd})")
        if abs(loss - ref_loss) > REMAT_LOSS_RTOL * abs(ref_loss) or \
                abs(norm - ref_norm) > REMAT_NORM_RTOL * ref_norm or \
                fwd != want_fwd:
            fail(f"remat policy {policy!r} differs from 'dots'")
    del params, leaves
    _free_cuda()
    return out


LAUNCHED_TRIAL = 3
LAUNCHED_STEPS = 10
# One rank of a launched trial (8c's, 12d's, 16b/d's: the example's
# GPT2Trial; 18b's: a conv model's trial) under core.init() from the
# launcher's and the agent's environment, as `python worker.py ROOT
# ENTRY`. Written into build/smoke at run time and started by the port's
# launcher.
LAUNCHED_WORKER = r'''
import importlib.util, json, os, sys
ROOT, ENTRY = sys.argv[1], sys.argv[2]
sys.path.insert(0, ROOT)
import torch
import torch.distributed as dist
from determined_tpu_torch import core
from determined_tpu_torch.ops import _build, flash_attention as fa
from determined_tpu_torch.train import Trainer
from determined_tpu_torch.train.trial import TrialContext

# ENTRY: "path/in/the/repo.py:Name", or "...:name()" for a factory.
path, name = ENTRY.split(":")
sys.path.insert(0, os.path.dirname(os.path.join(ROOT, path)))
spec = importlib.util.spec_from_file_location("entry", os.path.join(ROOT,
                                                                    path))
entry = importlib.util.module_from_spec(spec)
spec.loader.exec_module(entry)
Trial = getattr(entry, name.rstrip("()"))
if name.endswith("()"):
    Trial = Trial()

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ctx = core.init()
d = ctx.distributed
chief = d.is_chief
out = {"rank": d.rank, "size": d.size, "backend": d.backend,
       "group_backend": dist.get_backend(),
       "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
       "device": torch.cuda.get_device_name(torch.cuda.current_device()),
       "allgather": [b.decode() for b in d.transport.allgather_bytes(
           f"rank{d.rank}".encode())],
       "broadcast": d.transport.broadcast_bytes(
           b"from the chief" if chief else b"", chief).decode()}
trial = Trial(TrialContext(hparams=ctx.hparams, core_context=ctx,
                           n_devices=d.size))
trainer = Trainer(trial, core_context=ctx)
for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
    fn.launches = 0
fa.reference_attention.calls = 0
state = trainer.fit(report_period=5, preempt_period=5)
torch.cuda.synchronize()
out.update(mesh=dict(zip(trainer.mesh.mesh_dim_names,
                         trainer.mesh.mesh.shape)),
           step=state.step,
           launches={"fwd": fa.flash_fwd_cuda.launches,
                     "dq": fa.flash_dq_cuda.launches,
                     "dkv": fa.flash_dkv_cuda.launches},
           reference_calls=fa.reference_attention.calls,
           build_seconds=dict(_build.build_seconds),
           kernel_sources=dict(_build.sources),
           peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
print("RESULT " + json.dumps(out), flush=True)
ctx.close()
'''


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


GPT2_ENTRY = "examples/gpt2_cuda/model_def.py:GPT2Trial"


def launch_trial(workdir, hparams, storage, nproc, slots, backend=None,
                 trial_id=LAUNCHED_TRIAL, timeout=900, entry=GPT2_ENTRY,
                 env=None):
    """The example trial (`entry`: a trial class, "file:Name", or a
    factory of one, "file:name()") through `python -m
    determined_tpu_torch.launch.torch_distributed` against a fresh fake
    master with one op of LAUNCHED_STEPS, in `env` (default this
    process's): -> (each rank's RESULT, the master, the launcher's exit
    code, its output)."""
    script = os.path.join(workdir, "launched_worker.py")
    with open(script, "w") as f:
        f.write(LAUNCHED_WORKER)
    master = FakeMaster(LAUNCHED_STEPS)
    env = dict(os.environ if env is None else env)
    env.update({
        "DET_MASTER": master.url, "DET_TRIAL_ID": str(trial_id),
        "DET_EXPERIMENT_ID": "1", "DET_ALLOCATION_ID": f"launched-{nproc}",
        "DET_SESSION_TOKEN": "smoke", "DET_HPARAMS": json.dumps(hparams),
        "DET_EXPERIMENT_CONFIG": json.dumps({"checkpoint_storage": {
            "type": "shared_fs", "host_path": storage}}),
        "DET_TORCH_MASTER_PORT": str(free_port()),
        "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", "")})
    for k in ("DET_SLOT_IDS", "DET_TORCH_BACKEND", "CUDA_VISIBLE_DEVICES"):
        env.pop(k, None)
    if slots is not None:
        env["DET_SLOT_IDS"] = slots
    if backend is not None:
        env["DET_TORCH_BACKEND"] = backend
    try:
        proc = subprocess.run(
            [sys.executable, "-m",
             "determined_tpu_torch.launch.torch_distributed",
             "--nproc-per-node", str(nproc), "--", sys.executable, script,
             ROOT, entry], env=env, cwd=ROOT, capture_output=True, text=True,
            timeout=timeout)
    finally:
        master.release()
        master.close()
    results = {}
    for line in proc.stdout.splitlines():
        if "RESULT " in line:
            r = json.loads(line.split("RESULT ", 1)[1])
            results[r["rank"]] = r
    return results, master, proc.returncode, proc.stdout + proc.stderr


def phase_launched_trial(workdir, hparams, card, train=None):
    """8c: the example GPT-2 trial launched by the port's launcher on GPU
    slot 0 (`DET_SLOT_IDS="[0]"`) against the fake master of 7c, 10 steps
    at phase 7's hparams: the worker must see its slot, form a real NCCL
    process group (with the gloo control group beside it) and a
    DeviceMesh of the world, run the flash kernels, report through the
    chief and commit a checkpoint the master registers; a serve replica
    then restores it and its logits must equal the restored params'
    forward (fp32, 1e-3). The worker starts cold, as on a fresh node: its
    kernel directory is empty, so its first step builds the flash library
    with nvcc and hands it to the compile farm (a signature is set; the
    fake master takes the upload); 19b's warm run is held to it."""
    import shutil

    import numpy as np
    import torch

    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.serve.task import build_replica

    storage = os.path.join(workdir, "launched_checkpoints")
    kernels = os.path.join(workdir, "launched_kernels")
    for d in (storage, kernels):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.monotonic()
    results, master, rc, log = launch_trial(
        workdir, hparams, storage, 1, "[0]", env=dict(
            os.environ, DET_KERNEL_DIR=kernels,
            DET_COMPILE_SIGNATURE="smoke-8c-cold"))
    wall = time.monotonic() - t0
    with open(os.path.join(workdir, "launched_trial.log"), "w") as f:
        f.write(log)
    if rc != 0 or list(results) != [0]:
        say(log[-3000:])
        fail(f"the launched trial exited {rc} with results from ranks "
             f"{list(results)}")
    r = results[0]
    sid = f"trial{LAUNCHED_TRIAL}-step{LAUNCHED_STEPS}"
    losses = [b["metrics"]["loss"] for b in master.posted("/metrics")
              if b["group"] == "training" and "loss" in b["metrics"]]
    ops = [q for m, p, q, b in master.requests
           if p.endswith("/searcher/operation")]
    want = fit_launches(1, 1, 12)  # one capture at world 1, 1 val shape
    say(f"[launch] [{card}] 1 slot: the worker saw CUDA_VISIBLE_DEVICES="
        f"{r['cuda_visible_devices']} ({r['device']}), rank {r['rank']} of "
        f"{r['size']}, process group {r['group_backend']}, DeviceMesh "
        f"{r['mesh']}; gloo control plane: allgather {r['allgather']}, "
        f"broadcast {r['broadcast']!r}; searcher polls {len(ops)}, losses "
        f"{[round(x, 4) for x in losses]}, step {r['step']}, registry "
        f"{master.registry}, flash launches {r['launches']} (expected "
        f"{want}), reference calls {r['reference_calls']}; {wall:.1f} s")
    if r["cuda_visible_devices"] != "0" or r["group_backend"] != "nccl" \
            or r["size"] != 1 or r["mesh"].get("data") != 1 or \
            r["allgather"] != ["rank0"] or \
            r["broadcast"] != "from the chief" or r["step"] != \
            LAUNCHED_STEPS or master.registry != [sid] or \
            r["launches"] != want or r["reference_calls"] or \
            len(losses) != LAUNCHED_STEPS // 5 or \
            not master.posted("/searcher/completed_operation"):
        fail("the launched trial did not train through its slot's process "
             "group as expected")
    if train is not None:
        diffs = [abs(x - train["losses"][5 * (i + 1)])
                 for i, x in enumerate(losses)]
        say(f"[launch] losses at 5 and 10 against phase 7's: max |diff| "
            f"{max(diffs):.3e} (tolerance 1e-5; bitwise equal: "
            f"{max(diffs) == 0.0})")
        if max(diffs) > 1e-5:
            fail("the launched trial's losses differ from phase 7's")

    params = CheckpointContext(storage, trial_id=LAUNCHED_TRIAL
                               ).restore_params(sid)
    engine, _ = build_replica({
        "serving": {"model_config": {"model_size": "small",
                                     "dtype": "float32"},
                    "max_batch_size": 1, "max_seq_len": 256,
                    "kv_block_size": 16, "seed": SEED,
                    "checkpoint": sid},
        "checkpoint_storage": {"type": "shared_fs", "host_path": storage}})
    prompt = np.random.default_rng(SEED + 25).integers(
        0, 50257, 40).astype(np.int32)
    served = engine.prefill_logits(0, prompt).float()
    cfg = gpt2.Config(dtype=torch.float32)
    with torch.no_grad():
        direct = gpt2.apply(gpt2.map_params(lambda t: t.cuda(), params),
                            torch.from_numpy(prompt[None]).cuda(), cfg)[0, -1]
    worst = float((served.reshape(-1) - direct.float()).abs().max())
    say(f"[launch] [{card}] a serve replica restored {sid} from the "
        f"launched trial's storage: last-position logits against the "
        f"restored params' forward, max |diff| {worst:.3e} (atol 1e-3)")
    if worst > 1e-3:
        fail("the replica's logits differ from the launched trial's params")
    flush = first_flush(master)
    uploads = [n for b in master.posted("/compile_cache/smoke-8c-cold")
               for n in b["files"]]
    say(f"[launch] [{card}] cold start: harness.compile "
        f"{flush['compile_ms']:.1f} ms (train_step's first call), "
        f"compile_cache_hit {flush['compile_cache_hit']}, build_seconds "
        f"{r['build_seconds']}, uploaded {uploads}")
    if r["kernel_sources"] != {"flash_attention": "nvcc"} or \
            flush["compile_cache_hit"] != 0.0 or len(uploads) != 1:
        fail("the launched trial's cold start did not build and upload "
             "the flash library")
    del engine, params
    _free_cuda()
    return {"losses": losses, "wall_s": wall, "flush": flush, "result": r,
            "spans": compile_spans(master)}


# ------------------------------------------------------------------ phase 9


def phase_train_parity():
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.train import optim
    from determined_tpu_torch.train.state import create_train_state
    from determined_tpu_torch.train.step import make_train_step

    cfg = dataclasses.replace(gpt2.Config.small(), n_layer=2,
                              dtype=torch.float32)
    params0 = gpt2.init(torch.Generator(device="cuda").manual_seed(SEED + 5),
                        cfg)
    rng = np.random.default_rng(SEED + 6)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 1025)).astype(np.int32)).cuda()}
        for _ in range(3)]
    runs, grads = {}, {}
    for impl in ("kernel", "reference"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        flat = gpt2._flatten(params0)
        leaves = [t.detach().clone().requires_grad_() for t in flat.values()]
        loss = gpt2.loss_fn(gpt2._unflatten(dict(zip(flat, leaves))),
                            batches[0], c)
        grads[impl] = dict(zip(flat, torch.autograd.grad(loss, leaves)))
        tx = optim.chain(optim.clip_by_global_norm(1.0), optim.adamw(
            optim.warmup_cosine_decay_schedule(0.0, 1e-5, 1, 10000),
            b2=0.95, weight_decay=0.1))
        params = gpt2.map_params(lambda t: t.clone(), params0)
        state = create_train_state(lambda g: params, tx, None)
        step = make_train_step(lambda p, b, r: gpt2.loss_fn(p, b, c), tx)
        losses, norms = [], []
        for batch in batches:
            state, m = step(state, batch, None)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        runs[impl] = (losses, norms, [t.detach() for t in state.leaves()])
    (lk, nk, pk), (lr_, nr, pr) = runs["kernel"], runs["reference"]
    loss_diff = max(abs(a - b) for a, b in zip(lk, lr_))
    norm_rel = max(abs(a - b) / b for a, b in zip(nk, nr))
    param_diff = max(float((a - b).abs().max()) for a, b in zip(pk, pr))
    # Each leaf's gradient, relative to that leaf's largest element.
    grad_name, grad_rel = max(
        ((name, float((g - grads["reference"][name]).abs().max()
                      / grads["reference"][name].abs().max()))
         for name, g in grads["kernel"].items()), key=lambda kv: kv[1])
    say(f"[parity] fp32 GPT-2 small width, 2 layers, B 2, S 1024: step-0 "
        f"gradients, max |diff| / max |grad| of a leaf {grad_rel:.3e} "
        f"({grad_name}; limit 1e-5); 3 steps: losses "
        f"{[round(x, 6) for x in lk]} vs {[round(x, 6) for x in lr_]}, max "
        f"|loss diff| {loss_diff:.3e} (atol 1e-5), grad_norm rel "
        f"{norm_rel:.3e} (1e-4), max |param diff| {param_diff:.3e} (atol "
        "1e-6)")
    if grad_rel > 1e-5 or loss_diff > 1e-5 or norm_rel > 1e-4 or \
            param_diff > 1e-6:
        fail("training through the kernels differs from the plain version")


# ----------------------------------------------------------------- phase 10


# Device cycles of the wait before each timed launch: ~1 ms at the H100's
# clocks, longer than the host takes to reach the launch.
SLEEP_CYCLES = 2_000_000


def time_cold(fn, args, flush, iters=50, hide_host=True,
              sleep_cycles=SLEEP_CYCLES):
    """Median ms of `fn(*args)` over `iters` launches, each timed with its
    own CUDA events after a write that evicts the 50 MB L2. A device-side
    wait sits between the flush and the first event: the host's launch
    work (the wrapper's checks, the ctypes call) then overlaps it, and the
    events bracket the device's work alone, not the device idling until
    the launch arrives. `hide_host=False` leaves the wait out (PR 2's
    method): the time then holds whatever of the host's launch work
    outlasts the flush."""
    import torch

    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(iters):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(sleep_cycles)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def paged_bound(slots, pos, H=12, Dh=64, itemsize=2):
    """(least ms, what bounds it, bytes) of one paged launch with every slot
    at `pos`: q read and out written once, the visible K and V rows read
    once, the table entries and positions read once, at 3.35 TB/s; its
    4 (pos + 1) H Dh flops a slot at the bf16 peak."""
    keys = slots * (pos + 1)
    mb = -(-(pos + 1) // 16)
    nbytes = (2 * slots * H * Dh * itemsize + 2 * keys * H * Dh * itemsize
              + slots * mb * 4 + slots * 4)
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = 4 * keys * H * Dh / PEAK_FLOPS["torch.bfloat16"]
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations", nbytes)


def paged_inputs(slots, pos, gen, H=12, Dh=64, bs=16):
    """bf16 kernel inputs with every slot at `pos`, a permuted pool of
    max(64, enough) blocks a slot (64: the serving run's max_seq_len 1024),
    and the same lane gathered for the library call: [slots, H, S, Dh]."""
    import torch

    mb = max(64, -(-(pos + 1) // bs))
    P = slots * mb + 1
    dtype = torch.bfloat16
    q = torch.randn(slots, H, Dh, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(P, bs, H, Dh, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(P, bs, H, Dh, generator=gen, device="cuda").to(dtype)
    tables = torch.randperm(P - 1, generator=gen, device="cuda")
    tables = tables.reshape(slots, mb).to(torch.int32).contiguous()
    pos_t = torch.full((slots,), pos, dtype=torch.int32, device="cuda")
    lanes = [p[tables.long()].reshape(slots, mb * bs, H, Dh).transpose(1, 2)
             .contiguous() for p in (kp, vp)]
    mask = (torch.arange(mb * bs, device="cuda")[None, :]
            <= pos_t[:, None].long())[:, None, None, :]
    return (q, kp, vp, tables, pos_t), (q[:, :, None, :], *lanes, mask)


def phase_paged_times(card):
    import torch
    import torch.nn.functional as F

    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)

    def sdpa(q4, k4, v4, m4):
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    launches0 = paged_attention_cuda.launches
    rows = {}
    for slots in (8, 1):
        for pos in (1023, 320, 4095):
            args, lib_args = paged_inputs(slots, pos, gen)
            ms = time_cold(paged_attention_cuda, args, flush)
            library_ms = time_cold(sdpa, lib_args, flush)
            bound_ms, bound_by, nbytes = paged_bound(slots, pos)
            rows[slots, pos] = {"ms": ms, "library_ms": library_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by}
            if (slots, pos) == (8, 1023):  # the row of the kernels line
                rows[slots, pos]["plain_ms"] = time_cold(
                    paged_attention_reference, args, flush)
            say(f"[times] [{card}] paged_attention bf16 slots={slots} H=12 "
                f"Dh=64 bs=16 pos={pos}: kernel {ms:.4f} ms, SDPA over the "
                f"gathered lane {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; {nbytes / 1e6:.2f} MB at 3.35 TB/s; "
                f"{bound_ms / ms * 100:.1f}% of bound)"
                + (f", plain {rows[slots, pos]['plain_ms']:.4f} ms"
                   if "plain_ms" in rows[slots, pos] else ""))
            del args, lib_args
    # A decode step's 12 launches at pos 320, as serving makes them: one a
    # layer, each over its own layer's pool, timed together after one
    # flush (the 12 pools, 151 MB, do not fit in L2).
    layers = [paged_inputs(8, 320, gen)[0] for _ in range(12)]
    step_ms = time_cold(lambda: [paged_attention_cuda(*a) for a in layers],
                        (), flush, sleep_cycles=4 * SLEEP_CYCLES)
    paged_attention_cuda.launches = launches0  # timing runs do not count
    say(f"[times] [{card}] paged_attention bf16 slots=8 pos=320: 12 "
        f"launches x one launch's time = {12 * rows[8, 320]['ms']:.4f} ms; "
        f"12 launches over 12 layers' pools, timed together = "
        f"{step_ms:.4f} ms a decode step")
    del layers
    head = dict(rows[8, 1023])
    head["times"] = {f"slots{s}_pos{p}": r for (s, p), r in rows.items()}
    head["decode_step_12_launches_ms"] = step_ms
    return head


def flash_bound(b, s, h, d, causal=True, bf16=False):
    """The least time (ms) each flash kernel could take at this shape with
    bf16 inputs, and what bounds it: bytes (each input read once, each
    output written once, at 3.35 TB/s) or operations at the bf16 tensor
    rate. Q.K^T and dO.V^T are one bf16 product each. A product with P or
    dS in it is fp32 on the training path: it counts as three bf16
    products, the exact split, the least exact route on this card (one
    with `bf16`, which rounds P and dS). So the forward does 1 + 3, dQ
    2 + 3 and dK/dV 2 + 3 + 3 products of 2 S^2 D (causal: S(S+1)/2
    pairs) per head."""
    pairs = (s * (s + 1) // 2 if causal else s * s) * b * h
    prod = 2.0 * pairs * d  # FLOPs of one [S, S] x [S, D] product
    split = 1 if bf16 else 3
    tensor = b * s * h * d * 2
    stat = b * h * s * 4
    work = {"fwd": (4 * tensor + stat, 1 + split),
            "dq": (5 * tensor + 2 * stat, 2 + split),
            "dkv": (6 * tensor + 2 * stat, 2 + 2 * split)}
    out = {}
    for name, (nbytes, n_prod) in work.items():
        bytes_s = nbytes / HBM_BYTES_PER_S
        ops_s = n_prod * prod / PEAK_FLOPS["torch.bfloat16"]
        out[name] = (max(bytes_s, ops_s) * 1e3,
                     "bytes" if bytes_s >= ops_s else "operations", nbytes)
    return out


def phase_flash_times(card):
    import torch
    import torch.nn.functional as F

    from determined_tpu_torch.ops import flash_attention as fa

    b, s, h, d = FLASH_CASES[0][:4]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q, k, v, dout = flash_inputs(b, s, h, d, torch.bfloat16, gen)
    counts = [fn.launches for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda,
                                     fa.flash_dkv_cuda)]
    o, lse = fa.flash_fwd_cuda(q, k, v)
    delta = fa.flash_delta(dout, o)
    bwd_args = (q, k, v, dout, lse, delta)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    ms, ms_bf16 = {}, {}
    for out, bf16 in ((ms, False), (ms_bf16, True)):
        out["fwd"] = time_cold(fa.flash_fwd_cuda, (q, k, v, True, bf16),
                               flush)
        out["dq"] = time_cold(fa.flash_dq_cuda, (*bwd_args, True, bf16),
                              flush)
        out["dkv"] = time_cold(fa.flash_dkv_cuda, (*bwd_args, True, bf16),
                               flush)
    with_host = {
        "fwd": time_cold(fa.flash_fwd_cuda, (q, k, v), flush,
                         hide_host=False),
        "dq": time_cold(fa.flash_dq_cuda, bwd_args, flush, hide_host=False),
        "dkv": time_cold(fa.flash_dkv_cuda, bwd_args, flush,
                         hide_host=False)}
    plain = {"fwd": time_cold(fa.flash_fwd_reference, (q, k, v), flush,
                              iters=10),
             "dq": time_cold(fa.flash_dq_reference, bwd_args, flush,
                             iters=10),
             "dkv": time_cold(fa.flash_dkv_reference, bwd_args, flush,
                              iters=10)}
    for fn, n in zip((fa.flash_fwd_cuda, fa.flash_dq_cuda,
                      fa.flash_dkv_cuda), counts):
        fn.launches = n  # timing runs do not count
    # The yardstick: SDPA over [B, H, S, D] copies (the port never calls
    # it). It rounds P and dS to bf16: its like-for-like row is the
    # kernels' `bf16=True` time.
    q4, k4, v4, do4 = (t.transpose(1, 2).contiguous()
                       for t in (q, k, v, dout))
    lib_fwd = time_cold(
        lambda a, b_, c: F.scaled_dot_product_attention(a, b_, c,
                                                        is_causal=True),
        (q4, k4, v4), flush)
    leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    lib_bwd = time_cold(
        lambda: torch.autograd.grad(out, leaves, do4, retain_graph=True),
        (), flush)
    library = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
    bounds = flash_bound(b, s, h, d)
    bounds_bf16 = flash_bound(b, s, h, d, bf16=True)
    for name in ("fwd", "dq", "dkv"):
        bound_ms, bound_by, nbytes = bounds[name]
        say(f"[times] [{card}] flash {name} bf16 B{b} S{s} H{h} D{d} causal: "
            f"kernel {ms[name]:.4f} ms, plain {plain[name]:.4f} ms, library "
            f"{library[name]:.4f} ms (SDPA {'forward' if name == 'fwd' else 'autograd backward, dQ+dK+dV'}), "
            f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e6:.1f} MB; "
            f"{bound_ms / ms[name] * 100:.1f}% of bound); with bf16=True "
            f"(P and dS rounded, as SDPA): kernel {ms_bf16[name]:.4f} ms, "
            f"bound {bounds_bf16[name][0]:.4f} ms "
            f"({bounds_bf16[name][0] / ms_bf16[name] * 100:.1f}% of "
            f"bound); timed with the host's launch work (PR 2's method) "
            f"{with_host[name]:.4f} ms")
    return {name: {"ms": ms[name], "plain_ms": plain[name],
                   "library_ms": library[name], "bound_ms": bounds[name][0],
                   "bound_by": bounds[name][1], "bf16_ms": ms_bf16[name],
                   "bf16_bound_ms": bounds_bf16[name][0],
                   "with_host_ms": with_host[name]}
            for name in ("fwd", "dq", "dkv")}


# ----------------------------------------------------------------- phase 11


MOE_HPARAMS = {"num_experts": 8, "moe_top_k": 2}  # examples/gpt2/moe.yaml's
MOE_STEPS = 20


@contextlib.contextmanager
def recorded_routes():
    """Every `ops.moe.route` made inside the block (its Routing: probs,
    gate_idx, gate_vals, pos, kept, capacity), in call order."""
    from determined_tpu_torch.ops import moe

    seen, route = [], moe.route

    def recording(*args, **kwargs):
        r = route(*args, **kwargs)
        seen.append(r)
        return r

    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = route


def moe_active_flops_per_token(cfg, seq_len):
    """fwd+bwd FLOPs of what one token of an MoE GPT-2 runs: 6 x (the
    trunk's params + the router + top_k experts' FFN) + the attention
    term. `gpt2.flops_per_token` counts a dense FFN (the JAX package's
    formula). The experts compute E x C = 1.25 x T slots (capacity counts
    tokens, not assignments), so of the top-2 assignments at most 62.5 %
    are run; this counts all of them, as the standard active count does."""
    from determined_tpu_torch.models import gpt2

    d, f, L = cfg.d_model, cfg.ff_dim, cfg.n_layer
    ffn = d * f + f + f * d + d
    trunk = gpt2.param_count(cfg) - L * ffn
    router = L * d * cfg.num_experts
    experts = L * min(cfg.moe_top_k, cfg.num_experts) * ffn
    return 6.0 * (trunk + router + experts) + 12 * L * d * seq_len


def phase_moe_train(workdir, hparams, card):
    """11a: the example trial as Mixture-of-Experts GPT-2 small (8 experts,
    top-2, capacity factor 1.25, aux coefficient 0.01: examples/gpt2/
    moe.yaml's model) through `Trainer.fit`, 20 steps at phase 7's
    hparams on its token stream. Losses finite and falling; the flash
    kernels launched by phase 7's formula and the plain attention never
    run; one COMMITTED checkpoint (11c serves it). Prints the step time,
    tokens/s, the device's idle share (torch.profiler over 3 more steps),
    the peak memory, each layer's share of dropped routing assignments on
    a training batch, and MFU from the active FLOPs a token."""
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trainer import _to_device
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    ckpt_dir = os.path.join(workdir, "moe_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ctx = core.init(max_length=MOE_STEPS, checkpoint_dir=ckpt_dir)
    trial = GPT2Trial(TrialContext(hparams={**hparams, **MOE_HPARAMS},
                                   core_context=ctx))
    cfg = trial.cfg
    trainer = Trainer(trial, core_context=ctx)

    # The main path of 11a runs from here: every count starts at 0.
    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    fa.reference_attention.calls = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = trainer.fit(report_period=TRAIN_REPORT_PERIOD)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dq": fa.flash_dq_cuda.launches,
                "dkv": fa.flash_dkv_cuda.launches}
    ref_calls = fa.reference_attention.calls

    n_params = sum(p.numel() for p in state.leaves())
    reports = ctx.train.local_training_metrics
    losses = [r["metrics"]["loss"] for r in reports]
    val = ctx.train.local_validation_metrics
    say(f"[moe] [{card}] MoE GPT-2 small: {n_params:,} params ({cfg.n_layer} "
        f"layers x {cfg.num_experts} experts, top-{cfg.moe_top_k}, capacity "
        f"factor {cfg.moe_capacity_factor}, aux coefficient "
        f"{cfg.moe_aux_coef}), seq_len 1024, batch 8, {str(cfg.dtype)[6:]}, "
        f"remat {cfg.remat_policy!r}: fit {state.step} steps in {wall:.1f} "
        f"s; loss every {TRAIN_REPORT_PERIOD} steps "
        f"{[round(x, 4) for x in losses]}; validation "
        f"{val[-1]['metrics'] if val else None}; peak memory {peak_gib:.2f} "
        "GiB")
    if state.step != MOE_STEPS or \
            len(losses) != MOE_STEPS // TRAIN_REPORT_PERIOD:
        fail(f"fit ran {state.step} steps with {len(losses)} reports")
    if not all(x == x and abs(x) != float("inf") for x in losses) or \
            not losses[-1] < losses[0] - 0.25:
        fail(f"the MoE losses are not finite and falling: {losses}")
    captured_fit_step(trainer, reports[0]["metrics"], "[moe]")
    want = fit_launches(1, val_shapes(trial), cfg.n_layer)
    say(f"[moe] flash wrapper launches {launches} (expected {want}, phase "
        f"7's formula); reference_attention calls {ref_calls}")
    if launches != want or ref_calls != 0:
        fail(f"MoE training launched {launches} flash kernels (want {want}) "
             f"and the plain attention {ref_calls} times")
    sid = f"trial0-step{MOE_STEPS}"
    if ctx.checkpoint.lineage() != [sid] or not os.path.exists(
            os.path.join(ckpt_dir, sid, "COMMIT")):
        fail(f"MoE checkpoints: lineage {ctx.checkpoint.lineage()}")
    ctx.close()

    window_s = [TRAIN_REPORT_PERIOD / r["metrics"]["steps_per_second"]
                for r in reports[1:]]
    step_ms = sum(window_s) / (TRAIN_REPORT_PERIOD * len(window_s)) * 1e3
    breakdown = profile_train_steps(trainer, trial)
    idle = 1.0 - breakdown["busy_ms"] / step_ms
    tokens_per_s = 8 * 1024 / (step_ms / 1e3)
    active = moe_active_flops_per_token(cfg, 1024)
    mfu = active * tokens_per_s / PEAK_FLOPS["torch.bfloat16"]
    # Each layer's dropped share of the top-k assignments, on one
    # training batch through the trained params (no grad: no recompute).
    batch = _to_device(next(iter(trial.build_training_data())),
                       trainer.device)
    with torch.no_grad(), recorded_routes() as routes:
        gpt2.apply(trainer.state.params, batch["tokens"][:, :-1], cfg)
    dropped = [float(1 - r.kept.float().mean()) for r in routes]
    if len(dropped) != cfg.n_layer:
        fail(f"{len(routes)} routes for {cfg.n_layer} layers")
    say(f"[moe] [{card}] fit's step over steps {TRAIN_REPORT_PERIOD + 1}-"
        f"{MOE_STEPS}: {step_ms:.2f} ms (windows "
        f"{[round(w * 1e3 / TRAIN_REPORT_PERIOD, 2) for w in window_s]} ms a "
        f"step), {tokens_per_s:.0f} tokens/s; device busy "
        f"{breakdown['busy_ms']:.2f} ms a step, idle share {idle * 100:.1f}%;"
        f" active FLOPs a token {active:.4e} (dense formula "
        f"{gpt2.flops_per_token(cfg, 1024):.4e}), MFU {mfu * 100:.2f}% of "
        f"989 TFLOP/s; dropped share of the top-2 assignments by layer "
        f"{[round(x, 4) for x in dropped]} (capacity {routes[0].capacity} "
        f"slots an expert)")
    del trainer, state, batch
    _free_cuda()
    return {"launches": launches, "step_ms": step_ms,
            "tokens_per_s": tokens_per_s, "mfu": mfu, "idle_share": idle,
            "peak_gib": peak_gib, "dropped": dropped, "n_params": n_params,
            "ckpt_dir": ckpt_dir, "sid": sid, "losses": losses}


def phase_moe_multi_step(hparams, card, depth=12):
    """11b: `make_multi_step` (steps_per_call 4) over 2 windows against 8
    `make_train_step` calls from the same state and batches, MoE GPT-2
    small at full width: window-mean losses, grad norms and all_finite and
    every param must be bitwise equal (the routing is captured with the
    step: nothing in it reads the device on the host), and the replays
    must have launched the flash kernels."""
    import dataclasses

    import torch

    from determined_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.Config.small(), n_layer=depth,
                              **MOE_HPARAMS)
    run = replay_against_eager(cfg, hparams, SEED + 30)
    multi, means_r, means_e = run["multi"], run["means_r"], run["means_e"]
    L = cfg.n_layer
    replays = MULTI_STEPS * MULTI_WINDOWS - 1
    want_graph = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}
    in_replays = dict(multi.replayed_launches)
    flat_r = gpt2._flatten(run["replayed"].params)
    flat_e = gpt2._flatten(run["eager"].params)
    differ = [n for n in flat_e if not torch.equal(flat_r[n], flat_e[n])]
    bitwise = not differ and means_r == means_e
    say(f"[moe] [{card}] make_multi_step(steps_per_call={MULTI_STEPS}) x "
        f"{MULTI_WINDOWS} windows of MoE GPT-2 small ({L} layers) against "
        f"{MULTI_STEPS * MULTI_WINDOWS} make_train_step calls: window-mean "
        f"losses {[m['loss'] for m in means_r]} vs "
        f"{[m['loss'] for m in means_e]}, grad norms "
        f"{[m['grad_norm'] for m in means_r]} vs "
        f"{[m['grad_norm'] for m in means_e]}; params that differ "
        f"{differ[:4]} ({len(differ)} of {len(flat_e)}); bitwise equal "
        f"{bitwise}; the captured step holds {multi._graph_launches} flash "
        f"launches, the replays launched {in_replays}; reference calls "
        f"{run['ref_calls']}")
    if not bitwise:
        fail("the replayed MoE steps differ from make_train_step's")
    if multi.replays != replays or multi._graph_launches != want_graph or \
            in_replays != {k: v * replays for k, v in want_graph.items()} \
            or run["ref_calls"]:
        fail("the flash kernels did not run inside the MoE replays")
    del multi, run, flat_r, flat_e
    _free_cuda()
    return {"bitwise": bitwise, "replayed_launches": in_replays}


def phase_moe_serve(workdir, train, card):
    """11c: serve 11a's checkpoint. A bf16 replica through `build_replica`
    (8 slots, max_seq_len 1024, KV block 16, prefix cache on) behind
    `ServingServer`: phase 5's burst answered 200, the decode graph
    holding 12 paged launches and replayed for every decode step, the
    plain version never run; decode step p50, tokens/s, TTFT, and one
    replayed step's device ms and kernels. Then graph against eager
    logits (two prompts, 16 decode steps) must be bitwise equal. In fp32:
    a replica restored from the checkpoint and a dense-layout engine over
    its params must give the same greedy tokens with logits within 1e-3
    (all 8 slots busy with 64-token prompts: no idle slot or padded row
    routes), and the replica's logits of a 64-token prompt (bucket 64)
    must match the params' own training forward within 1e-3."""
    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops.paged_attention import (
        paged_attention_cuda, paged_attention_reference)
    from determined_tpu_torch.serve.engine import ServingEngine
    from determined_tpu_torch.serve.http import ServingServer
    from determined_tpu_torch.serve.task import build_replica

    def config(dtype, **serving):
        return {"serving": {
            "model_config": {"model_size": "small", "dtype": dtype,
                             **MOE_HPARAMS},
            "checkpoint": "latest", "max_batch_size": 8,
            "max_seq_len": 1024, "kv_block_size": 16, "prefix_cache": True,
            "seed": SEED, **serving},
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": train["ckpt_dir"]}}

    # The main path of 11c runs from here: every count starts at 0.
    paged_attention_cuda.launches = 0
    paged_attention_reference.calls = 0
    t0 = time.monotonic()
    engine, batcher = build_replica(config("bfloat16"))
    decode_s = []
    decode = engine.decode

    def timed_decode(*args):
        t = time.perf_counter()
        out = decode(*args)
        decode_s.append(time.perf_counter() - t)
        return out

    engine.decode = timed_decode
    batcher.start()
    graphs = engine.stats()["cuda_graphs"]
    say(f"[moe-serve] bf16 replica of {train['sid']} restored and captured "
        f"in {time.monotonic() - t0:.1f} s; graphs (paged launches each "
        f"holds) {graphs}")
    want = {"decode", "copy_block"} | {
        f"prefill_{b}" for b in engine.prefill_buckets}
    if set(graphs) != want or graphs["decode"] != engine.cfg.n_layer:
        fail(f"MoE replica captured {graphs}")
    server = ServingServer(batcher, host="127.0.0.1", port=0).start()
    try:
        bodies, wall = serve_burst(f"http://127.0.0.1:{server.port}",
                                   np.random.default_rng(SEED + 40),
                                   engine.cfg.vocab_size)
    finally:
        server.stop()
        batcher.stop()
    est = engine.stats()
    replayed = est["attention_launches"]
    launches = paged_attention_cuda.launches + replayed + graphs["decode"]
    ref_calls = paged_attention_reference.calls
    run = burst_summary(bodies, wall, decode_s)
    say(f"[moe-serve] [{card}] {len(bodies)} requests answered 200 with 64 "
        f"tokens each: decode step p50 {run['decode_step_ms']:.3f} ms over "
        f"{run['decode_steps']} steps, {run['tokens_per_s']:.1f} tokens/s, "
        f"TTFT p50 {run['ttft_p50_ms']:.1f} ms; paged launches on the path "
        f"{launches} ({replayed} replayed for {est['decode_steps']} decode "
        f"steps), reference calls {ref_calls}")
    if est["decode_steps"] <= 0 or \
            replayed != engine.cfg.n_layer * est["decode_steps"] or ref_calls:
        fail("the MoE replica's decode did not replay the paged kernel")
    engine.decode = decode
    steps = decode_step_times(engine, card)
    for s in range(engine.slots):
        engine.release_slot(s)
    prompts = two_prompts(engine, np.random.default_rng(SEED + 41))
    _, got, want_l, same = generate_logits(engine, prompts, 16,
                                           twin=EagerTwin(engine))
    bitwise = all(torch.equal(x, y) for x, y in zip(got, want_l))
    say(f"[moe-serve] [{card}] bf16 graph vs eager, two prefills (buckets "
        f"512, 64 after a 256-token prefix hit) + 16 decode steps: greedy "
        f"equal {same}, max |logit diff| {max_diff(got, want_l):.3e}, "
        f"bitwise equal {bitwise}")
    if not bitwise:
        fail("the MoE replica's graphs differ from its eager calls")
    del engine, batcher
    _free_cuda()

    fp32, _ = build_replica(config("float32"))
    dense = ServingEngine(fp32.params, fp32.cfg, slots=8, max_seq_len=1024,
                          attention_impl="dense", seed=SEED, device="cuda")
    # Every slot busy and every prompt filling its bucket: an idle slot or
    # a padded row is routed too (ROADMAP Queue 3), and what it attends to
    # differs between the layouts (the trash block, or its own lane).
    mb = fp32.max_blocks_per_seq
    rng = np.random.default_rng(SEED + 42)
    full = [(s, rng.integers(0, fp32.cfg.vocab_size, 64).astype(np.int32),
             np.arange(s * mb, (s + 1) * mb, dtype=np.int32), 0)
            for s in range(fp32.slots)]
    toks_p, got_p, _, _ = generate_logits(fp32, full, 16)
    toks_d, got_d, _, _ = generate_logits(dense, full, 16)
    worst_pd = max_diff(got_p, got_d)
    prompt = np.random.default_rng(SEED + 43).integers(
        0, fp32.cfg.vocab_size, 64).astype(np.int32)
    served = fp32.prefill_logits(0, prompt).float()
    with torch.no_grad():
        direct = gpt2.apply(fp32.params, torch.from_numpy(prompt[None]).cuda(),
                            fp32.cfg)[0, -1]
    worst_fw = float((served - direct.float()).abs().max())
    say(f"[moe-serve] [{card}] fp32 replica of {train['sid']}: paged vs "
        f"dense, 8 slots of 64-token prompts + 16 decode steps, greedy equal "
        f"{toks_p == toks_d}, max |logit diff| {worst_pd:.3e} (atol 1e-3); "
        f"a 64-token prompt's logits against the params' training forward "
        f"max |diff| {worst_fw:.3e} (atol 1e-3)")
    if toks_p != toks_d or worst_pd > 1e-3 or worst_fw > 1e-3:
        fail("the MoE replica's paged, dense and training logits disagree")
    del fp32, dense
    _free_cuda()
    return {"launches": launches, "run": run, "steps": steps,
            "bitwise": bitwise}


def phase_moe_parity():
    """11d: fp32, MoE GPT-2 small width, 2 layers, B 2, S 1024: the flash
    kernels against the plain attention. The routing first: every route
    (forward and remat recompute) must choose the same experts and keep
    the same assignments; then each leaf's step-0 gradient within 1e-5
    of that leaf's largest element (phase 9's bound)."""
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.Config.small(), n_layer=2,
                              dtype=torch.float32, **MOE_HPARAMS)
    params0 = gpt2.init(torch.Generator(device="cuda").manual_seed(SEED + 50),
                        cfg)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(
        SEED + 51).integers(0, cfg.vocab_size, (2, 1025)).astype(
            np.int32)).cuda()}
    grads, routes, losses = {}, {}, {}
    for impl in ("kernel", "reference"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        flat = gpt2._flatten(params0)
        leaves = [t.detach().clone().requires_grad_() for t in flat.values()]
        with recorded_routes() as seen:
            loss = gpt2.loss_fn(gpt2._unflatten(dict(zip(flat, leaves))),
                                batch, c)
            grads[impl] = dict(zip(flat, torch.autograd.grad(loss, leaves)))
        routes[impl], losses[impl] = seen, float(loss)
    rk, rr = routes["kernel"], routes["reference"]
    same_idx = len(rk) == len(rr) and all(
        torch.equal(a.gate_idx, b.gate_idx) for a, b in zip(rk, rr))
    same_kept = len(rk) == len(rr) and all(
        torch.equal(a.kept, b.kept) for a, b in zip(rk, rr))
    dropped = [round(float(1 - r.kept.float().mean()), 4) for r in rk]
    grad_name, grad_rel = max(
        ((name, float((g - grads["reference"][name]).abs().max()
                      / grads["reference"][name].abs().max()))
         for name, g in grads["kernel"].items()), key=lambda kv: kv[1])
    say(f"[moe-parity] fp32 MoE GPT-2 small width, 2 layers, B 2, S 1024, "
        f"kernel vs plain attention: {len(rk)} routes (forward + remat "
        f"recompute), gate_idx identical {same_idx}, kept identical "
        f"{same_kept}, dropped shares {dropped}; losses "
        f"{losses['kernel']:.6f} / {losses['reference']:.6f}; step-0 "
        f"gradients, max |diff| / max |grad| of a leaf {grad_rel:.3e} "
        f"({grad_name}; limit 1e-5)")
    if not (same_idx and same_kept):
        fail("the kernels' MoE routing differs from the plain attention's")
    if grad_rel > 1e-5:
        fail("MoE training through the kernels differs from the plain "
             "version")


# ----------------------------------------------------------------- phase 12


LONG_SEQ = 8192        # examples/gpt2_cuda/long_context.yaml's seq_len
# Its global batch of 16, cut to what one card holds: 8 does not (the
# backward asked for 12.27 GiB more with 56.44 GiB allocated and 18.41
# GiB reserved, most of it the loss's [8, 8192, 50257] logits in bf16
# and fp32 and their gradient), 4 does.
LONG_BATCH = 4
LONG_STEPS = 20
RING_CHUNKS = 4        # long_context.yaml's context: 4
# 12b's checks. fp32 (the FFMA kernels): the ring only reorders fp32 sums,
# so max |ring - x| <= RING_FP32_TOL x max |x|, x the full-length call and
# the plain ring. bf16 (the tensor-core kernels) is held element by
# element:
#   - against the full-length kernels, |ring - x| <= atol + rtol |x| with
#     RING_BF16_TOL[x] = (atol as a multiple of the rms of x, rtol). o
#     and dq: rtol 2^-7, two bf16 roundings of a value (its block's and
#     the final one); dk and dv: 2^-6, because each is the sum of several
#     ranks' parts, each rounded, which together can be larger than the
#     sum. atol covers those roundings where the parts cancel. A
#     calibration run of this phase on an H100 (PERF.md) needed, at rtol
#     2^-7, 6.52e-3 (o), 7.87e-3 (dq), 1.63e-2 (dk) and 1.73e-2 (dv) of
#     the rms; at 2^-7, dk and dv used 0.92 and 0.94 of the allowance
#     where |x| is large. atol is about twice what was needed;
#   - against the plain ring (the same schedule on the kernels' plain
#     versions: the same bf16 roundings of each block's o, dq, dk and dv),
#     the share of bf16 values of o, dq, dk and dv that differ within
#     RING_MISMATCH_LIMIT. A block's value differs from the plain one
#     only near a rounding tie, as in phase 4 (0.5 % there), and the fp32
#     combine carries each block's tie into the final value: the
#     calibration run measured 0.217-0.380 %;
#   - lse (fp32) against both with phase 4's tolerance.
# Planted faults (one block's o x 1.05, one block's dK x 1.05, and the
# backward reading each block's own lse for the combined one) must each
# be refused.
RING_FP32_TOL = 1e-5
RING_MISMATCH_LIMIT = 0.01
RING_BF16_TOL = {"o": (2 ** -6, 2 ** -7), "dq": (2 ** -6, 2 ** -7),
                 "dk": (2 ** -5, 2 ** -6), "dv": (2 ** -5, 2 ** -6)}


def long_hparams(hparams):
    """12a's hparams: long_context.yaml's model and optimizer (GPT-2 small,
    seq_len 8192, ring attention, lr 3e-4) on phase 7's token stream, the
    mesh `context: 1` of one card and the batch cut to LONG_BATCH."""
    return {**hparams, "seq_len": LONG_SEQ, "global_batch_size": LONG_BATCH,
            "learning_rate": 3e-4, "attention_impl": "ring",
            "mesh": {"data": -1, "context": 1}}


def phase_long_context_train(workdir, hparams, card):
    """12a: the long-context trial through `Trainer.fit` on one card:
    GPT-2 small at S 8192 with `attention_impl: ring`, which at a context
    axis of 1 is the flash kernels (the JAX ring's fallback). 20 steps on
    phase 7's token stream and the op-end validation: losses finite and
    falling, the flash kernels launched by phase 7's formula and the plain
    attention never run. Prints fit's step, tokens/s, MFU, the idle share
    (3 more steps under torch.profiler) with each flash kernel's device ms
    a layer, and the peak memory."""
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    ckpt_dir = os.path.join(workdir, "long_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ctx = core.init(max_length=LONG_STEPS, checkpoint_dir=ckpt_dir)
    trial = GPT2Trial(TrialContext(hparams=long_hparams(hparams),
                                   core_context=ctx))
    cfg = trial.cfg
    trainer = Trainer(trial, core_context=ctx)
    say(f"[long] [{card}] GPT-2 small at seq_len {LONG_SEQ} "
        f"({gpt2.param_count(cfg):,} params with n_positions "
        f"{cfg.n_positions}), attention_impl {cfg.attention_impl!r}, mesh "
        f"{trial.mesh_config()} on one card; global batch "
        f"{LONG_BATCH} (long_context.yaml's 16 cut to one card), "
        f"{str(cfg.dtype)[6:]}, remat {cfg.remat_policy!r}, {LONG_STEPS} "
        "steps")

    # The main path of 12a runs from here: every count starts at 0.
    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    fa.reference_attention.calls = 0
    fa.flash_fwd_reference.calls = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    state = trainer.fit(report_period=TRAIN_REPORT_PERIOD)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dq": fa.flash_dq_cuda.launches,
                "dkv": fa.flash_dkv_cuda.launches}
    plain_calls = fa.reference_attention.calls + fa.flash_fwd_reference.calls
    reports = ctx.train.local_training_metrics
    losses = [r["metrics"]["loss"] for r in reports]
    val = ctx.train.local_validation_metrics
    say(f"[long] fit {state.step} steps in {wall:.1f} s; loss every "
        f"{TRAIN_REPORT_PERIOD} steps {[round(x, 4) for x in losses]}; "
        f"validation {val[-1]['metrics'] if val else None}; peak memory "
        f"{peak_gib:.2f} GiB")
    if state.step != LONG_STEPS or \
            len(losses) != LONG_STEPS // TRAIN_REPORT_PERIOD or not val:
        fail(f"fit ran {state.step} steps with {len(losses)} reports and "
             f"{len(val)} validations")
    if not all(x == x and abs(x) != float("inf") for x in losses) or \
            not losses[-1] < losses[0] - 0.25:
        fail(f"the long-context losses are not finite and falling: {losses}")
    captured_fit_step(trainer, reports[0]["metrics"], "[long]")
    want = fit_launches(1, val_shapes(trial), cfg.n_layer)
    say(f"[long] flash wrapper launches {launches} (expected {want}, phase "
        f"7's formula); plain attention calls {plain_calls}")
    if launches != want or plain_calls != 0:
        fail(f"the long-context fit launched {launches} flash kernels (want "
             f"{want}) and the plain attention {plain_calls} times")
    ctx.close()

    window_s = [TRAIN_REPORT_PERIOD / r["metrics"]["steps_per_second"]
                for r in reports[1:]]
    step_ms = sum(window_s) / (TRAIN_REPORT_PERIOD * len(window_s)) * 1e3
    breakdown = profile_train_steps(trainer, trial)
    idle = 1.0 - breakdown["busy_ms"] / step_ms
    tokens_per_s = LONG_BATCH * LONG_SEQ / (step_ms / 1e3)
    mfu = gpt2.flops_per_token(cfg, LONG_SEQ) * tokens_per_s / PEAK_FLOPS[
        "torch.bfloat16"]
    # Each flash kernel's device ms a layer at S 8192 (the forward runs
    # twice a layer a step: once more in the remat recompute).
    per_layer = {}
    for key, runs in (("fwd", 2), ("dq", 1), ("dkv", 1)):
        per_layer[key] = sum(v for g, v in breakdown["groups"].items()
                             if g.startswith(f"flash_{key}_")) / (
                                 runs * cfg.n_layer)
    bounds = flash_bound(LONG_BATCH, LONG_SEQ, cfg.n_head, cfg.head_dim)
    say(f"[long] [{card}] fit's step over steps {TRAIN_REPORT_PERIOD + 1}-"
        f"{LONG_STEPS}: {step_ms:.2f} ms (windows "
        f"{[round(w * 1e3 / TRAIN_REPORT_PERIOD, 2) for w in window_s]} ms a "
        f"step), {tokens_per_s:.0f} tokens/s, MFU {mfu * 100:.2f}% of 989 "
        f"TFLOP/s (flops_per_token at S {LONG_SEQ} "
        f"{gpt2.flops_per_token(cfg, LONG_SEQ):.4e}); device busy "
        f"{breakdown['busy_ms']:.2f} ms a step, idle share "
        f"{idle * 100:.1f}%; flash device ms a layer at B {LONG_BATCH}, S "
        f"{LONG_SEQ}: " + ", ".join(
            f"{k} {v:.3f} (bound {bounds[k][0]:.3f}, "
            f"{bounds[k][0] / v * 100:.1f}% of it)"
            for k, v in per_layer.items()))
    del trainer, state
    _free_cuda()
    return {"launches": launches, "step_ms": step_ms,
            "tokens_per_s": tokens_per_s, "mfu": mfu, "idle_share": idle,
            "peak_gib": peak_gib, "per_layer_ms": per_layer,
            "bound_ms": {k: b[0] for k, b in bounds.items()},
            "losses": losses}


def ring_schedule(q, k, v, dout, chunks, forward, backward, combine, finish):
    """The ring's per-block work for context ranks 0..chunks-1 in turn, in
    one process: rank r attends its q chunk to the K/V blocks the ring
    hands it (r, r-1, ..., skipping the later ones under the causal rule)
    and, in the backward, adds each block's dK/dV to that block's
    accumulator, as the ring carries it home. -> (o, lse [B*H, S], dq, dk,
    dv), lse in sequence order."""
    import torch

    from determined_tpu_torch.ops import flash_attention as fa

    ra = importlib.import_module("determined_tpu_torch.ops.ring_attention")
    n = q.shape[1] // chunks

    def part(t, i):
        return t[:, i * n:(i + 1) * n]

    outs, lses, dqs = [], [], []
    dk = [torch.zeros(part(k, 0).shape, dtype=torch.float32,
                      device=q.device) for _ in range(chunks)]
    dv = [torch.zeros_like(x) for x in dk]
    for r in range(chunks):
        qr, dor = part(q, r), part(dout, r).contiguous()
        acc, seen = None, []
        for step in range(chunks):
            src = (r - step) % chunks
            causal = ra.block_causal(src, r, True)
            if causal is None:
                continue
            p = forward(qr, part(k, src), part(v, src), causal)
            acc = p if acc is None else combine(*acc, *p)
            seen.append((src, causal))
        o, lse = finish(*acc, q.dtype)
        delta = fa.flash_delta(dor, o)
        dq = torch.zeros(qr.shape, dtype=torch.float32, device=q.device)
        for src, causal in seen:
            dq_j, dk_j, dv_j = backward(qr, part(k, src), part(v, src), dor,
                                        lse, delta, causal)
            dq += dq_j
            dk[src] += dk_j
            dv[src] += dv_j
        outs.append(o)
        lses.append(lse)
        dqs.append(dq.to(q.dtype))
    cat = functools.partial(torch.cat, dim=1)
    return (cat(outs), cat(lses), cat(dqs), cat([t.to(k.dtype) for t in dk]),
            cat([t.to(v.dtype) for t in dv]))


def plain_block_forward(q, k, v, causal):
    """The ring's block forward on the kernels' plain version."""
    import torch

    from determined_tpu_torch.ops import flash_attention as fa

    o, lse = fa.flash_fwd_reference(q, k, v, causal)
    b, s, h, _ = q.shape
    m = lse.view(b, h, s)
    return m, torch.ones_like(m), o.float()


def plain_block_backward(q, k, v, dout, lse, delta, causal):
    from determined_tpu_torch.ops import flash_attention as fa

    return (fa.flash_dq_reference(q, k, v, dout, lse, delta, causal),
            *fa.flash_dkv_reference(q, k, v, dout, lse, delta, causal))


def ring_faults(ra):
    """12b's planted faults: (name, block forward, block backward), each
    wrong in one way. The schedule's forward calls come in rank order,
    each rank's blocks from its own back to chunk 0 (rank 3's block of
    chunk 1 is the 9th); its backward calls in the same order."""
    def scaled(fn, index, factor, out):
        calls = []

        def wrapped(*args):
            res = list(fn(*args))
            if len(calls) == index:
                res[out] = res[out] * factor
            calls.append(1)
            return tuple(res)
        return wrapped

    stash = []

    def remember(q, k, v, causal):
        m, l, o = ra.block_forward(q, k, v, causal)
        stash.append(m.reshape(-1, m.shape[-1]).contiguous())
        return m, l, o

    def own_lse(q, k, v, dout, lse, delta, causal):
        return ra.block_backward(q, k, v, dout, stash.pop(0), delta, causal)

    return (("one block's o x 1.05 (rank 3, chunk 1)",
             scaled(ra.block_forward, 8, 1.05, 2), ra.block_backward),
            ("one block's dK x 1.05 (rank 2, chunk 0)",
             ra.block_forward, scaled(ra.block_backward, 5, 1.05, 1)),
            ("the backward reads each block's own lse", remember, own_lse))


def ring_verdict(ring, full, plain, dtype):
    """12b's checks of one schedule's (o, lse, dq, dk, dv) against the
    full-length kernels and the plain ring -> (the failures, a reading of
    each check)."""
    import torch

    names = ("o", "lse", "dq", "dk", "dv")
    bad, seen = [], []
    if dtype == torch.float32:
        for name, got, w_full, w_plain in zip(names, ring, full, plain):
            scale = float(w_full.float().abs().max())
            rel = [float((got.float() - w.float()).abs().max()) / scale
                   for w in (w_full, w_plain)]
            seen.append(f"{name} {rel[0]:.2e} / {rel[1]:.2e}")
            if max(rel) > RING_FP32_TOL:
                bad.append(f"{name}: max |ring - x| / max |x| {rel} above "
                           f"{RING_FP32_TOL:g}")
        return bad, "max |ring - x| / max |x|, x the full-length kernels / " \
            f"the plain ring (limit {RING_FP32_TOL:g}): " + ", ".join(seen)
    lse_tol = flash_tolerances(dtype, False)["lse"]
    for name, got, w_full, w_plain in zip(names, ring, full, plain):
        if name == "lse":
            shares = [held(got, w, *lse_tol)[1] for w in (w_full, w_plain)]
            seen.append(f"lse: allowance used {shares[0]:.2f} (full) / "
                        f"{shares[1]:.2f} (plain), phase 4's")
            if max(shares) > 1.0:
                bad.append(f"lse outside phase 4's tolerance ({shares})")
            continue
        g, w = got.float(), w_full.float()
        rms = float(w.pow(2).mean().sqrt())
        atol_rms, rtol = RING_BF16_TOL[name]
        err, share = held(got, w_full, atol_rms * rms, rtol)
        need = float(((g - w).abs() - rtol * w.abs()).max())
        differ = mismatch(got, w_plain)
        seen.append(f"{name}: max err {err:.2e}, rms {rms:.2e}, atol needed "
                    f"at rtol {rtol:.3g} {need / rms:.2e} rms, allowance "
                    f"used {share:.2f}; differing bf16 values "
                    f"{differ * 100:.3f}%")
        if share > 1.0:
            bad.append(f"{name} outside atol {atol_rms:g} rms rtol "
                       f"{rtol:.3g} of the full-length kernels ({share:.2f} "
                       "of the allowance)")
        if differ > RING_MISMATCH_LIMIT:
            bad.append(f"{name}: {differ * 100:.3f}% of the bf16 values "
                       "differ from the plain ring's (limit "
                       f"{RING_MISMATCH_LIMIT * 100:g}%)")
    return bad, "; ".join(seen)


def phase_ring_blocks(card):
    """12b: the ring's block schedule on the card. q, k, v at B 4, S 8192,
    H 12, D 64 (per-head views of a fused product), split into 4 chunks,
    bf16 and fp32: every rank's blocks in turn through
    ops/ring_attention.py's `block_forward`, `_combine`, `finish` and
    `block_backward`, against one launch of each kernel at the full S and
    against the same schedule on the kernels' plain versions (the checks
    above RING_FP32_TOL). Each kernel must launch 10 times (4 + 3 + 2 + 1
    blocks under the causal rule). In bf16 the planted faults must be
    refused. -> the launches."""
    import torch

    from determined_tpu_torch.ops import flash_attention as fa

    ra = importlib.import_module("determined_tpu_torch.ops.ring_attention")
    b, s, h, d = 4, LONG_SEQ, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    want = sum(range(1, RING_CHUNKS + 1))
    kernels = (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, dout = flash_inputs(b, s, h, d, dtype, gen)
        before = [f.launches for f in kernels]
        t0 = time.monotonic()
        ring = ring_schedule(q, k, v, dout, RING_CHUNKS, ra.block_forward,
                             ra.block_backward, ra._combine, ra.finish)
        torch.cuda.synchronize()
        ring_s = time.monotonic() - t0
        launches = {key: f.launches - n for key, f, n in zip(
            ("fwd", "dq", "dkv"), kernels, before)}
        o, lse = fa.flash_fwd_cuda(q, k, v)
        delta = fa.flash_delta(dout.contiguous(), o)
        full = (o, lse, fa.flash_dq_cuda(q, k, v, dout, lse, delta),
                *fa.flash_dkv_cuda(q, k, v, dout, lse, delta))
        plain = ring_schedule(q, k, v, dout, RING_CHUNKS,
                              plain_block_forward, plain_block_backward,
                              ra._combine, ra.finish)
        bad, reading = ring_verdict(ring, full, plain, dtype)
        say(f"[ring] [{card}] {str(dtype)[6:]} B{b} S{s} H{h} D{d} in "
            f"{RING_CHUNKS} chunks, ring schedule {ring_s:.2f} s: launches "
            f"{launches} (want {want} each); {reading}")
        if launches != {"fwd": want, "dq": want, "dkv": want}:
            fail(f"the ring schedule launched {launches}, want {want} each")
        if bad:
            fail(f"the ring's blocks differ from the full-length kernels or "
                 f"the plain ring in {str(dtype)[6:]}: " + "; ".join(bad))
        if dtype == torch.bfloat16:
            for name, fwd, bwd in ring_faults(ra):
                wrong = ring_schedule(q, k, v, dout, RING_CHUNKS, fwd, bwd,
                                      ra._combine, ra.finish)
                refused, _ = ring_verdict(wrong, full, plain, dtype)
                say(f"[ring] planted fault '{name}' refused by: "
                    + ("; ".join(refused) or "nothing"))
                if not refused:
                    fail(f"12b's checks pass the planted fault '{name}'")
                del wrong
        for f, n in zip(kernels, before):
            f.launches = n  # the checks' launches do not count
        out = launches
        del q, k, v, dout, ring, full, plain
        _free_cuda()
    return out


def phase_ulysses_inner(card):
    """12c: the kernels at the Ulysses inner shape, [B, S, H/4, D] = [4,
    8192, 3, 64] bf16 contiguous (what the all-to-all hands them), against
    their plain version with phase 4's tolerances."""
    import torch

    from determined_tpu_torch.ops import flash_attention as fa

    b, s, h, d = 4, LONG_SEQ, 12 // RING_CHUNKS, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=gen, device="cuda"
                                 ).to(torch.bfloat16) for _ in range(4))
    before = [f.launches for f in (fa.flash_fwd_cuda, fa.flash_dq_cuda,
                                   fa.flash_dkv_cuda)]
    o, lse = fa.flash_fwd_cuda(q, k, v)
    delta = fa.flash_delta(dout, o)
    got = {"o": o, "lse": lse,
           "dq": fa.flash_dq_cuda(q, k, v, dout, lse, delta)}
    got["dk"], got["dv"] = fa.flash_dkv_cuda(q, k, v, dout, lse, delta)
    launches = [f.launches - n for f, n in zip(
        (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda), before)]
    o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
    want = {"o": o_ref, "lse": lse_ref,
            "dq": fa.flash_dq_reference(q, k, v, dout, lse, delta)}
    want["dk"], want["dv"] = fa.flash_dkv_reference(q, k, v, dout, lse, delta)
    tol = flash_tolerances(torch.bfloat16, False)
    worst, shares = 0.0, {}
    for name in got:
        atol, rtol = tol["o" if name == "o" else "lse" if name == "lse"
                         else "grad"]
        err, share = held(got[name], want[name], atol, rtol)
        worst = max(worst, err)
        shares[name] = share
    say(f"[ulysses] [{card}] the kernels at the Ulysses inner shape B{b} "
        f"S{s} H{h} D{d} bf16: launches {launches}; share of each "
        "tolerance used (phase 4's): "
        + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()))
    if launches != [1, 1, 1] or any(v > 1.0 for v in shares.values()):
        fail("the kernels at the Ulysses inner shape differ from their "
             "plain version")
    # ulysses_attention without a mesh (a context axis of 1) on the card:
    # the kernels, one launch each, the same values as the calls above.
    ul = importlib.import_module("determined_tpu_torch.ops.ulysses")
    before = [f.launches for f in (fa.flash_fwd_cuda, fa.flash_dq_cuda,
                                   fa.flash_dkv_cuda)]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o_ul = ul.ulysses_attention(qg, kg, vg)
    grads = torch.autograd.grad(o_ul, (qg, kg, vg), dout)
    launches = [f.launches - n for f, n in zip(
        (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda), before)]
    same = [bool(torch.equal(a, got[n])) for a, n in
            zip((o_ul, *grads), ("o", "dq", "dk", "dv"))]
    say(f"[ulysses] [{card}] ulysses_attention at context 1 on the card: "
        f"launches {launches}; o, dq, dk, dv equal to the kernels' above: "
        f"{same}")
    if launches != [1, 1, 1] or not all(same):
        fail("ulysses_attention at context 1 did not run the flash "
             "kernels")
    for f, n in zip((fa.flash_fwd_cuda, fa.flash_dq_cuda,
                     fa.flash_dkv_cuda), before):
        f.launches = n  # a check's launches do not count
    del q, k, v, dout, got, want, qg, kg, vg, o_ul, grads
    _free_cuda()
    return worst


# 12d's limits on world 2 against world 1, relative, over the report
# windows (steps 5 and 10). The two runs start from the same params and
# differ in bf16 roundings and sum orders (the ring's blocks each round
# their outputs once more), and Adam turns a gradient element's noise
# into an update of the learning rate's size, so the trajectories part
# from the first step: a four-card run of this phase (PERF.md) read
# 1.08e-3 (loss) and 1.55e-2 (grad norm) at context 2. The limits are
# about three times that. A gradient scaled by the context size, the
# mistake the step's reduction can make, leaves the losses as they are
# (Adam after the clip does not see the scale) and doubles the grad norm.
SPLIT_LOSS_RTOL = 4e-3
SPLIT_NORM_RTOL = 5e-2


def phase_split_world(workdir, hparams, card):
    """12d: with two cards, the example trial launched at world 2 over
    NCCL, `context: 2` with ring attention, and `tensor: 2`, each against
    a world of one at the same hparams: the losses and grad norms of each
    report window (SPLIT_LOSS_RTOL, SPLIT_NORM_RTOL; world_against_one,
    phase 16); prints the last report window's step of each. With one
    card: not run."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        say(f"[12d] not run: {n} card")
        return None
    out = {}
    for name, extra in (("context", {"mesh": {"data": 1, "context": 2},
                                     "attention_impl": "ring"}),
                        ("tensor", {"mesh": {"data": 1, "tensor": 2}})):
        out[name] = world_against_one(workdir, hparams, "12d", name, extra,
                                      card, LAUNCHED_TRIAL + 10)[0]
    return out


# ------------------------------------------------------------------ main


# ----------------------------------------------------------------- phase 13


# The other model families: models/mnist.py, resnet.py and diffusion.py.
MNIST_STEPS = 100          # examples/mnist_cuda/config.yaml's max_length
RESNET50_BATCH = 256       # bench_resnet.py's
RESNET50_WINDOW = 10       # bench_resnet.py's steps_per_call
RESNET50_IMAGE_FLOPS = 4.1e9   # a forward at 224x224 (bench_resnet.py)
CIFAR_BATCH, CIFAR_STEPS, CIFAR_REPORT = 128, 30, 5
DIFFUSION_STEPS, DIFFUSION_REPORT, DIFFUSION_TRIAL = 60, 10, 2
# One trial's point of finetune_asha.yaml's search space: the middle of
# the log range of learning rates, the middle clip, the middle decay.
DIFFUSION_POINT = {"learning_rate": 1e-4, "grad_clip": 1.0,
                   "weight_decay": 0.025}
PRETRAIN_STEPS, SAMPLE_N = 20, 8
PARITY_TOL = 1e-4          # 13d: of each leaf's largest element


def yaml_hparams(path):
    """The scalar entries of a config file's `hyperparameters:` block (the
    card's host has no PyYAML); a searched entry (a nested block) is left
    out."""
    out, inside = {}, False
    with open(path) as f:
        for line in f:
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            if not line.startswith(" "):
                inside = line.startswith("hyperparameters:")
                continue
            if not inside or line.startswith("    "):
                continue
            key, _, val = line.strip().partition(":")
            val = val.strip()
            if not val:
                continue
            for cast in (int, float, str):
                try:
                    out[key] = cast(val)
                    break
                except ValueError:
                    pass
    return out


def load_example(rel, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finite_and_falling(losses):
    return all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]


def report_losses(ctx):
    return [r["metrics"]["loss"] for r in ctx.train.local_training_metrics
            if "loss" in r["metrics"]]


def fit_step_ms(ctx):
    """Fit's own step time: the mean of `steps_per_second` over the
    report windows after the first."""
    rates = [r["metrics"]["steps_per_second"]
             for r in ctx.train.local_training_metrics[1:]
             if "steps_per_second" in r["metrics"]]
    return 1e3 / statistics.mean(rates)


def phase_mnist(workdir, card):
    """13a: examples/mnist_cuda through `core.init(max_length=100)` and
    `Trainer.fit` with config.yaml's hparams."""
    import shutil

    from determined_tpu_torch import core
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    ex = load_example("examples/mnist_cuda/model_def.py", "mnist_cuda_ex")
    hp = yaml_hparams(os.path.join(ROOT, "examples/mnist_cuda/config.yaml"))
    ckpt = os.path.join(workdir, "mnist_checkpoints")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.monotonic()
    ctx = core.init(max_length=MNIST_STEPS, checkpoint_dir=ckpt)
    trial = ex.MNistTrial(TrialContext(hparams=hp, core_context=ctx))
    state = Trainer(trial, core_context=ctx).fit(validation_period=0,
                                                 report_period=10)
    ctx.close()
    wall = time.monotonic() - t0
    losses = report_losses(ctx)
    val = ctx.train.local_validation_metrics[-1]["metrics"]
    say(f"[13a] [{card}] MNIST, hparams {hp}: {state.step} steps through "
        f"Trainer.fit in {wall:.1f} s; losses every 10 steps "
        f"{[round(x, 4) for x in losses]}; validation loss "
        f"{val['validation_loss']:.4f}, accuracy "
        f"{val['validation_accuracy']:.4f} (synthetic set); step "
        f"{fit_step_ms(ctx):.3f} ms")
    if state.step != MNIST_STEPS or not finite_and_falling(losses):
        fail(f"13a: MNIST losses not finite and falling: {losses}")
    return {"wall_s": wall}


def profile_conv_steps(run_step, n_steps=3):
    """Device time of `n_steps` calls of `run_step` under torch.profiler,
    by group: convolutions (cuDNN's kernels), BatchNorm (models/resnet.py
    `_BatchNorm`'s forward and backward, each wrapped in a record_function
    range for the window) and the rest; and the profiled loop's idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from determined_tpu_torch.models import resnet

    fwd, bwd = resnet._BatchNorm.forward, resnet._BatchNorm.backward

    def fwd_ranged(ctx, *a):
        with record_function("smoke.bn_forward"):
            return fwd(ctx, *a)

    def bwd_ranged(ctx, *a):
        with record_function("smoke.bn_backward"):
            return bwd(ctx, *a)

    run_step()  # warm, unprofiled
    resnet._BatchNorm.forward = staticmethod(fwd_ranged)
    resnet._BatchNorm.backward = staticmethod(bwd_ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                run_step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        resnet._BatchNorm.forward = staticmethod(fwd)
        resnet._BatchNorm.backward = staticmethod(bwd)
    busy = conv = bn = 0.0
    per_kernel = {}
    conv_re = re.compile(r"conv|xmma|cudnn|implicit_gemm|fprop|dgrad|wgrad",
                         re.I)
    for ev in prof.key_averages():
        kind = str(getattr(ev, "device_type", "")).split(".")[-1]
        if ev.key.startswith("smoke."):
            if kind == "CPU":
                us = getattr(ev, "device_time_total", None)
                bn += (ev.cuda_time_total if us is None else us) / 1e3
            continue
        if kind != "CUDA":
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        busy += us / 1e3
        per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + us / 1e3
        if conv_re.search(ev.key):
            conv += us / 1e3
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]:
        say(f"[profile]   {ms / n_steps:8.3f} ms/step  "
            f"{'conv ' if conv_re.search(name) else ''}{name[:100]}")
    return {"wall_ms": wall / n_steps, "busy_ms": busy / n_steps,
            "conv_ms": conv / n_steps, "bn_ms": bn / n_steps,
            "other_ms": (busy - conv - bn) / n_steps,
            "idle_share": max(0.0, 1.0 - busy / wall)}


def leaves_diff(got, want):
    """(largest |got - want| / max |want| over the leaves, bitwise equal)."""
    import torch

    pairs = list(zip(got, want, strict=True))
    return (max(_rel(a.float(), b.float()) for a, b in pairs),
            all(bool(torch.equal(a, b)) for a, b in pairs))


def phase_resnet50(card, batch=RESNET50_BATCH):
    """13b: ResNet-50 at ImageNet shapes, bf16, sgd(0.1, momentum=0.9), as
    bench_resnet.py runs it: make_multi_step (10 steps a call) against 10
    make_train_step calls from the same state, then the replayed and eager
    step times, MFU, the profile and the input A/B."""
    import numpy as np
    import torch

    from determined_tpu_torch.data.bench import ab_compare
    from determined_tpu_torch.models import resnet
    from determined_tpu_torch.train import optim
    from determined_tpu_torch.train.state import create_train_state, \
        extra_leaves
    from determined_tpu_torch.train.step import make_multi_step, \
        make_train_step

    cfg = resnet.Config.resnet50()
    n = RESNET50_WINDOW

    def loss(p, extra, b, rng):
        return resnet.loss_fn(p, extra, b, rng, cfg)

    def fresh():
        tx = optim.sgd(0.1, momentum=0.9)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
        params, stats = resnet.init(gen, cfg)
        return tx, create_train_state(lambda g: params, tx, gen,
                                      device="cuda", extra=stats)

    rng = np.random.default_rng(SEED + 31)
    window = {
        "images": torch.from_numpy(rng.normal(size=(
            n, batch, 224, 224, 3)).astype(np.float32)).to(
            "cuda", torch.bfloat16),
        "labels": torch.from_numpy(rng.integers(
            0, cfg.n_classes, (n, batch)).astype(np.int32)).to("cuda")}
    batches = [{k: v[i] for k, v in window.items()} for i in range(n)]
    t_start = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    tx, one = fresh()
    step = make_train_step(loss, tx, stateful=True)
    acc = None
    for b in batches:
        one, m = step(one, b, None)
        v = m["loss"].float().reshape(())
        acc = v.clone() if acc is None else acc.add_(v)
    one_loss = float(acc / n)
    tx, multi = fresh()
    multi_step = make_multi_step(loss, tx, n, stateful=True)
    multi, mm = multi_step(multi, window, None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    checks = {
        "params": leaves_diff(multi.leaves(), one.leaves()),
        "BN stats": leaves_diff(extra_leaves(multi.extra),
                                extra_leaves(one.extra)),
        "momentum": leaves_diff(multi.opt_state["trace"],
                                one.opt_state["trace"])}
    l_same = float(mm["loss"]) == one_loss
    bitwise = l_same and all(same for _, same in checks.values())
    say(f"[13b] ResNet-50 ({sum(p.numel() for p in one.leaves()):,} "
        f"params), B {batch}, 224x224, bf16, sgd(0.1, momentum=0.9): "
        f"make_multi_step ({n} steps, {multi_step.replays} replays) against "
        f"{n} make_train_step calls, cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}: mean loss "
        f"{float(mm['loss']):.6f} vs {one_loss:.6f} (bitwise {l_same}); "
        + "; ".join(f"{k} max rel {r:.3e} (bitwise {s})"
                    for k, (r, s) in checks.items())
        + f"; peak memory {peak:.2f} GiB (both states and the graph's pool)"
        f"; {time.monotonic() - t_start:.1f} s")
    if multi.step != one.step or \
            max(r for r, _ in checks.values()) > 1e-6 or \
            abs(float(mm["loss"]) - one_loss) > 1e-6 * abs(one_loss):
        fail("13b: the replayed stateful steps differ from single steps")
    del one
    _free_cuda()

    # Step times: the replayed window (bench_resnet.py's scan) and eager.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        multi, mm = multi_step(multi, window, None)
    float(mm["loss"])
    replay_ms = (time.perf_counter() - t0) * 1e3 / (2 * n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        multi, m = step(multi, b, None)
    float(m["loss"])
    eager_ms = (time.perf_counter() - t0) * 1e3 / n
    flops = 3 * RESNET50_IMAGE_FLOPS * batch

    def mfu(ms):
        return flops / (ms / 1e3) / PEAK_FLOPS["torch.bfloat16"] * 100

    prof = profile_conv_steps(lambda: step(multi, batches[0], None))
    say(f"[13b] [{card}] ResNet-50 bf16, B {batch}: replayed step "
        f"{replay_ms:.2f} ms, {batch / replay_ms * 1e3:.1f} samples/s, MFU "
        f"{mfu(replay_ms):.2f}% of 989 TFLOP/s (3 x 4.1 GFLOP an image); "
        f"eager step {eager_ms:.2f} ms, {batch / eager_ms * 1e3:.1f} "
        f"samples/s, MFU {mfu(eager_ms):.2f}%; 3 eager steps under "
        f"torch.profiler: wall {prof['wall_ms']:.2f} ms a step, device busy "
        f"{prof['busy_ms']:.2f} ms (convolutions {prof['conv_ms']:.2f}, "
        f"BatchNorm {prof['bn_ms']:.2f}, other {prof['other_ms']:.2f}), "
        f"idle share {prof['idle_share'] * 100:.1f}%; peak memory "
        f"{peak:.2f} GiB")
    step_s = min(max(eager_ms / 1e3, 0.01), 0.2)
    del multi, multi_step, window, batches
    _free_cuda()

    def make_iter():
        host = np.random.default_rng(1)

        def gen():
            for _ in range(6):
                yield {"images": host.random(size=(64, 224, 224, 3),
                                             dtype=np.float32),
                       "labels": host.integers(0, 1000, size=(64,)).astype(
                           np.int32)}
        return gen()

    ab = ab_compare(make_iter, lambda b: time.sleep(step_s), device="cuda",
                    depth=2)
    say(f"[13b] [{card}] input A/B over ResNet-shaped host batches (B 64, "
        f"224x224x3 fp32, a step of {step_s * 1e3:.1f} ms): prefetch "
        f"speedup {ab['speedup']}, input_wait_ms synchronous "
        f"{ab['sync']['input_wait_ms']} / prefetched "
        f"{ab['prefetch']['input_wait_ms']}, h2d_ms "
        f"{ab['prefetch'].get('h2d_ms')} (information)")
    return {"replay_ms": replay_ms, "eager_ms": eager_ms, "peak_gib": peak,
            "profile": prof, "batch": batch, "bitwise": bitwise}


def cifar_trial_class():
    """A ResNet-18 CIFAR stateful trial, defined here (the JAX package has
    no ResNet example): a learnable synthetic set, each class a color
    shift of normal noise. bf16 activations, or fp32 with the hparam
    `dtype: float32` (18b's reading of what bf16 rounding adds)."""
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import resnet
    from determined_tpu_torch.train import TorchTrial, optim

    class CifarTrial(TorchTrial):
        stateful = True

        def __init__(self, context):
            super().__init__(context)
            self.cfg = resnet.Config.resnet18_cifar()
            if context.hparams.get("dtype") == "float32":
                self.cfg = dataclasses.replace(self.cfg, dtype=torch.float32)
            rng = np.random.default_rng(SEED + 40)
            self.shift = rng.normal(size=(10, 1, 1, 3)).astype(np.float32)

        def _batches(self, seed, n=None):
            rng = np.random.default_rng(seed)
            b = self.context.global_batch_size
            i = 0
            while n is None or i < n:
                labels = rng.integers(0, 10, b).astype(np.int32)
                images = rng.normal(size=(b, 32, 32, 3)).astype(np.float32)
                yield {"images": images + self.shift[labels],
                       "labels": labels}
                i += 1

        def init_params(self, rng):
            return resnet.init(rng, self.cfg)[0]

        def init_extra(self):
            return resnet.init_stats(self.cfg)

        def loss(self, params, extra, batch, rng):
            return resnet.loss_fn(params, extra, batch, rng, self.cfg)

        def param_logical_axes(self):
            return resnet.param_logical_axes(self.cfg)

        def optimizer(self):
            return optim.sgd(0.1, momentum=0.9)

        def build_training_data(self):
            return self._batches(SEED + 41)

        def build_validation_data(self):
            return self._batches(SEED + 42, n=4)

        def evaluate(self, params, extra, batch):
            loss, aux, _ = resnet.loss_fn(params, extra, batch, None,
                                          self.cfg, train=False)
            return {"validation_loss": loss, "accuracy": aux["accuracy"]}

    return CifarTrial


def phase_cifar_trial(workdir, card):
    """13c: ResNet-18 CIFAR as a stateful trial through `Trainer.fit`: B
    128 at 32x32, 30 steps, the op-end validation on the running stats,
    one COMMITTED checkpoint that restores params, momentum and BN stats
    bit-identical."""
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.state import create_train_state
    from determined_tpu_torch.train.trial import TrialContext

    ckpt = os.path.join(workdir, "cifar_checkpoints")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.monotonic()
    ctx = core.init(max_length=CIFAR_STEPS, checkpoint_dir=ckpt)
    trial = cifar_trial_class()(TrialContext(
        hparams={"global_batch_size": CIFAR_BATCH}, core_context=ctx))
    trainer = Trainer(trial, core_context=ctx)
    state = trainer.fit(report_period=CIFAR_REPORT)
    wall = time.monotonic() - t0
    losses = report_losses(ctx)
    val = ctx.train.local_validation_metrics[-1]["metrics"]
    ids = [r["uuid"] for r in ctx.checkpoint.local_reported]
    template = create_train_state(
        trial.init_params, trial.optimizer(),
        torch.Generator(device="cuda").manual_seed(SEED), device="cuda",
        extra=trial.init_extra())
    back = ctx.checkpoint.restore_state(ids[-1], template)
    ctx.close()
    got, want = state_tensors(back), state_tensors(state)
    same = len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    say(f"[13c] [{card}] ResNet-18 CIFAR (stateful), B {CIFAR_BATCH}, "
        f"32x32, bf16, {state.step} steps through Trainer.fit in "
        f"{wall:.1f} s: losses every {CIFAR_REPORT} steps "
        f"{[round(x, 4) for x in losses]}, step {fit_step_ms(ctx):.2f} ms; "
        f"validation on the running stats: loss "
        f"{val['validation_loss']:.4f}, accuracy "
        f"{val['validation_accuracy']:.4f}; checkpoints {ids}, restored "
        f"bit-identical ({len(got)} tensors: params, momentum, BN stats): "
        f"{same}")
    if state.step != CIFAR_STEPS or not finite_and_falling(losses) or \
            ids != [f"trial0-step{CIFAR_STEPS}"] or not same or \
            not math.isfinite(val["validation_loss"]):
        fail("13c: the stateful trial did not train, validate and restore")
    del trainer, state, back, template
    _free_cuda()


def _grads_on(device, dtype, model, params, batch):
    """(output, new stats or None, {leaf path: gradient}) of `model`'s
    loss on `device` in `dtype`, from CPU tensors `params` and `batch`,
    all returned on the CPU in float64."""
    import torch

    from determined_tpu_torch.models.gpt2 import _flatten, _unflatten, \
        map_params

    def cast(t):
        return t.to(device, dtype if t.is_floating_point() else t.dtype)

    flat = _flatten(params)
    leaves = [cast(t.detach()).requires_grad_(True) for t in flat.values()]
    out, stats, loss = model(_unflatten(dict(zip(flat, leaves))),
                             map_params(cast, batch), dtype)
    grads = torch.autograd.grad(loss, leaves)

    def back(t):
        return t.detach().cpu().double()

    return (back(out), None if stats is None else
            {k: back(v) for k, v in _flatten(stats).items()},
            {k: back(g) for k, g in zip(flat, grads)})


def _rel(a, b):
    """max |a - b| / max |b| (or / 1 where b is 0)."""
    return float((a - b).abs().max() / (b.abs().max() or 1.0))


def phase_conv_parity(card):
    """13d: ResNet-50 (B 4, 224) and the diffusion base config, each
    through the port on CUDA and on the CPU (the path the CPU tests hold
    to JAX), TF32 off. In float64 the output, the new BN stats and each
    leaf's gradient must agree within PARITY_TOL of that leaf's largest
    element: the two paths compute one function. In fp32 the output and
    the stats must agree within PARITY_TOL too, and the gradients are
    read against the CPU's float64 ones: ResNet-50's fp32 gradients are
    themselves far from float64 at B 4 (deep leaves' terms cancel in
    BatchNorm's backward, on either device), so the CUDA path's worst
    leaf may be at most twice as far from float64 as the CPU's worst
    leaf, or PARITY_TOL."""
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import diffusion, resnet
    from determined_tpu_torch.models.gpt2 import map_params

    rng = np.random.default_rng(SEED + 50)
    rcfg = resnet.Config.resnet50()
    rparams, rstats = resnet.init(torch.Generator().manual_seed(SEED + 51),
                                  rcfg)
    # A nonzero head, so that every gradient is.
    rparams["head"]["kernel"] = torch.from_numpy(
        0.01 * rng.normal(size=tuple(rparams["head"]["kernel"].shape))
        .astype(np.float32))
    rbatch = {"images": torch.from_numpy(rng.normal(size=(4, 224, 224, 3))
                                         .astype(np.float32)),
              "labels": torch.from_numpy(rng.integers(0, 1000, 4)
                                         .astype(np.int32))}

    def resnet_model(p, b, dtype):
        cfg = dataclasses.replace(rcfg, dtype=dtype, param_dtype=dtype)
        stats = map_params(lambda t: t.to(b["images"].device, dtype), rstats)
        logits, new = resnet.apply(p, stats, b["images"], cfg, train=True)
        labels = b["labels"].long()
        loss = -torch.log_softmax(logits, -1).gather(
            -1, labels[:, None]).mean()
        return logits, new, loss

    dcfg = diffusion.Config()
    dparams = diffusion.init(torch.Generator().manual_seed(SEED + 52), dcfg)
    dparams["conv_out"]["kernel"] = torch.from_numpy(
        0.05 * rng.normal(size=tuple(dparams["conv_out"]["kernel"].shape))
        .astype(np.float32))
    dbatch = {"x0": torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3))
                                     .astype(np.float32)),
              "t": torch.from_numpy(rng.integers(0, dcfg.timesteps, 4)),
              "eps": torch.from_numpy(rng.normal(size=(4, 32, 32, 3))
                                      .astype(np.float32))}

    def diffusion_model(p, b, dtype):
        cfg = dataclasses.replace(dcfg, dtype=dtype)
        ab = diffusion.alpha_bars(cfg, b["x0"].device)[b["t"]].to(dtype)
        xt = torch.sqrt(ab)[:, None, None, None] * b["x0"] + \
            torch.sqrt(1 - ab)[:, None, None, None] * b["eps"]
        out = diffusion.apply(p, xt, b["t"], cfg)
        return out, None, torch.mean((out - b["eps"]) ** 2)

    for name, model, params, batch in (
            ("ResNet-50, B 4, 224", resnet_model, rparams, rbatch),
            ("diffusion base, B 4, 32", diffusion_model, dparams, dbatch)):
        t0 = time.monotonic()
        run = {(dev, str(dt)[6:]): _grads_on(dev, dt, model, params, batch)
               for dev in ("cuda", "cpu")
               for dt in (torch.float64, torch.float32)}
        verdict = {}
        for prec in ("float64", "float32"):
            (go, gs, gg), (co, cs_, cg) = run["cuda", prec], run["cpu", prec]
            stat = 0.0 if gs is None else max(
                _rel(gs[k], cs_[k]) for k in cs_)
            leaf, grad = max(((k, _rel(g, cg[k])) for k, g in gg.items()),
                             key=lambda kv: kv[1])
            verdict[prec] = (_rel(go, co), stat, grad, leaf)
        o64, s64, g64, l64 = verdict["float64"]
        o32, s32, g32, l32 = verdict["float32"]
        ref = run["cpu", "float64"][2]
        far = {dev: max(_rel(g, ref[k]) for k, g in run[dev, "float32"][2]
                        .items()) for dev in ("cuda", "cpu")}
        say(f"[13d] [{card}] parity, {name}, CUDA against CPU (TF32 off). "
            f"float64: output {o64:.3e}, new BN stats {s64:.3e}, worst "
            f"gradient leaf {g64:.3e} ({l64}; limit {PARITY_TOL}). fp32: "
            f"output {o32:.3e}, new BN stats {s32:.3e} (limit "
            f"{PARITY_TOL}), worst gradient leaf {g32:.3e} ({l32}); the fp32 "
            f"gradients' worst leaf against the CPU's float64 ones: CUDA "
            f"{far['cuda']:.3e}, CPU {far['cpu']:.3e} (CUDA at most "
            f"max({PARITY_TOL}, 2x the CPU's)); {time.monotonic() - t0:.1f} s")
        if max(o64, s64, g64, o32, s32) > PARITY_TOL or \
                far["cuda"] > max(PARITY_TOL, 2 * far["cpu"]):
            fail(f"13d: {name} on CUDA differs from the CPU path")
    _free_cuda()


def phase_diffusion(workdir, card):
    """13e: the diffusion example as a managed trial against a fake
    master, pretrain.py into a fine-tune through `pretrained_path`, and
    `sample` through the CUDA graph against the eager loop."""
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.models import diffusion
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.state import param_leaves
    from determined_tpu_torch.train.trial import TrialContext

    ex = load_example("examples/diffusion_cuda/model_def.py",
                      "diffusion_cuda_ex")
    hp = {**yaml_hparams(os.path.join(
        ROOT, "examples/diffusion_cuda/finetune_asha.yaml")),
        **DIFFUSION_POINT}
    storage = os.path.join(workdir, "diffusion_checkpoints")
    shutil.rmtree(storage, ignore_errors=True)
    env = {"DET_TRIAL_ID": str(DIFFUSION_TRIAL), "DET_EXPERIMENT_ID": "2",
           "DET_ALLOCATION_ID": "smoke-diffusion",
           "DET_SESSION_TOKEN": "smoke", "DET_HPARAMS": json.dumps(hp),
           "DET_EXPERIMENT_CONFIG": json.dumps({"checkpoint_storage": {
               "type": "shared_fs", "host_path": storage}})}
    master = FakeMaster(DIFFUSION_STEPS)
    t0 = time.monotonic()
    try:
        with cluster_env(DET_MASTER=master.url, **env):
            ctx = core.init()
            if ctx.info is None:
                fail("13e: core.init() did not take the cluster environment")
            trial = ex.DiffusionTrial(TrialContext(hparams=ctx.hparams,
                                                   core_context=ctx))
            state = Trainer(trial, core_context=ctx).fit(
                report_period=DIFFUSION_REPORT)
            master.release()
            ctx.close()
    finally:
        master.close()
    wall = time.monotonic() - t0
    train = [b for b in master.posted("/metrics")
             if b["group"] == "training" and "loss" in b["metrics"]]
    losses = [b["metrics"]["loss"] for b in train]
    vals = [b for b in master.posted("/metrics") if b["group"] ==
            "validation"]
    ckpts = [(c["uuid"], c["state"])
             for c in master.posted("/api/v1/checkpoints")]
    ops = master.posted("/searcher/completed_operation")
    step_ms = statistics.mean(1e3 / b["metrics"]["steps_per_second"]
                              for b in train[1:])
    end = f"trial{DIFFUSION_TRIAL}-step{DIFFUSION_STEPS}"
    say(f"[13e] [{card}] diffusion base (bf16, 32x32, B {hp['global_batch_size']}), "
        f"a managed trial at {DIFFUSION_POINT}: {state.step} steps in "
        f"{wall:.1f} s, step {step_ms:.2f} ms; losses every "
        f"{DIFFUSION_REPORT} steps {[round(x, 4) for x in losses]}; "
        f"validation reports "
        f"{[(b['steps_completed'], round(b['metrics']['validation_loss'], 4)) for b in vals]}; "
        f"checkpoints {ckpts}; completed op {ops}")
    if state.step != DIFFUSION_STEPS or not finite_and_falling(losses) or \
            [b["steps_completed"] for b in vals] != [DIFFUSION_STEPS] or \
            (end, "COMPLETED") not in ckpts or len(ops) != 1:
        fail("13e: the managed diffusion trial did not train, validate and "
             "commit")
    params = state.params
    del state

    pretrain = load_example("examples/diffusion_cuda/pretrain.py",
                            "diffusion_cuda_pretrain")
    path = os.path.join(workdir, "diffusion_pretrained.pkl")
    t0 = time.monotonic()
    pretrain.main(["--steps", str(PRETRAIN_STEPS), "--batch", "64",
                   "--out", path])
    ctx = core.init(max_length=1, checkpoint_dir=os.path.join(
        workdir, "diffusion_finetune"))
    trainer = Trainer(ex.DiffusionTrial(TrialContext(hparams={
        **hp, "pretrained_path": path}, core_context=ctx)), core_context=ctx)
    trainer._build(SEED)
    want = diffusion.params_from_numpy(ex.load_params(path), "cuda")
    got_leaves = trainer.state.leaves()
    same = all(torch.equal(a, b) for a, b in
               zip(got_leaves, param_leaves(want), strict=True))
    ctx.close()
    say(f"[13e] pretrain.py {PRETRAIN_STEPS} steps, then the trial through "
        f"pretrained_path: step-0 params bit-equal to the file: {same} "
        f"({time.monotonic() - t0:.1f} s)")
    if not same:
        fail("13e: the fine-tune did not start from the pretrained file")
    del trainer, want, got_leaves
    _free_cuda()

    cfg = diffusion.Config()
    out, ms = {}, {}
    for mode in ("graph", "eager"):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[mode] = diffusion.sample(params, gen, SAMPLE_N, cfg,
                                     graph=mode == "graph")
        torch.cuda.synchronize()
        ms[mode] = (time.perf_counter() - t0) * 1e3 / cfg.timesteps
    same = torch.equal(out["graph"], out["eager"])
    lo, hi = float(out["graph"].min()), float(out["graph"].max())
    say(f"[13e] [{card}] sample n {SAMPLE_N}, T {cfg.timesteps}, bf16: "
        f"graph {ms['graph']:.3f} ms a denoising step, eager "
        f"{ms['eager']:.3f} ms ({ms['eager'] / ms['graph']:.1f}x); bitwise "
        f"equal {same}; values in [{lo:.4f}, {hi:.4f}]")
    if not same or lo < -1.0 or hi > 1.0 or \
            not bool(torch.isfinite(out["graph"]).all()):
        fail("13e: the graph's samples differ from the eager loop's")
    del params, out
    _free_cuda()
    return {"sample_ms": ms, "step_ms": step_ms}


def phase_other_models(workdir, card):
    """Phase 13, each sub-phase's wall time printed."""
    times = {}
    for name, fn in (("13a", lambda: phase_mnist(workdir, card)),
                     ("13b", lambda: phase_resnet50(card)),
                     ("13c", lambda: phase_cifar_trial(workdir, card)),
                     ("13d", lambda: phase_conv_parity(card)),
                     ("13e", lambda: phase_diffusion(workdir, card))):
        t0 = time.monotonic()
        times[name] = (fn(), time.monotonic() - t0)
        say(f"[{name}] wall {times[name][1]:.1f} s")
    return {k: v[0] for k, v in times.items()}


# ----------------------------------------------------------------- phase 14

TORCH_TRIAL_STEPS = 30
TORCH_TRIAL_REPORT = 5
TORCH_TRIAL_ID = 14
TORCH_TRIAL_PREEMPT_AT = 15
ZERO_STEPS = 20


def torch_trial_example():
    return load_example("examples/gpt2_torch_cuda/model_def.py",
                        "gpt2_torch_cuda_model_def")


def torch_trial_hparams(hparams, **extra):
    """examples/gpt2_torch_cuda's hparams at GPT-2 small, S 1024, on phase
    7's token stream."""
    return {"model_size": "small", "seq_len": 1024,
            "per_device_batch_size": 8, "learning_rate": 3e-4,
            "tokens_path": hparams["tokens_path"], **extra}


def step_times(trial):
    """Wrap `trial.train_batch` to keep the host clock after each step (it
    ends in `loss.item()`, a device sync): -> the list it appends to."""
    stamps = [time.monotonic()]
    real = trial.train_batch

    def timed(*a, **k):
        out = real(*a, **k)
        stamps.append(time.monotonic())
        return out

    trial.train_batch = timed
    return stamps


def steady_step_ms(stamps, skip):
    """Mean ms a step over the steps after the first `skip`."""
    gaps = [b - a for a, b in zip(stamps, stamps[1:])][skip:]
    return statistics.mean(gaps) * 1e3


def module_state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def tensors_equal(a, b):
    """Nested dicts/lists of tensors and python values, bitwise."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and \
            a.shape == b.shape and torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(
            tensors_equal(x, y) for x, y in zip(a, b))
    return a == b


def phase_torch_trial(workdir, hparams, card, train_step_ms=None):
    """14a: examples/gpt2_torch_cuda's PyTorchTrial (GPT-2 small, B 8, S
    1024, bf16 compute, fp32 params, AdamW) through
    `determined_tpu_torch.pytorch.Trainer.fit` under a local
    `core.init(max_length=30)` with shared_fs storage; a fresh trial
    restores the final checkpoint through `restore_path`; then the trial
    managed against 7c's FakeMaster, preempted after step 15's report
    and resumed from `DET_LATEST_CHECKPOINT` to 30."""
    import shutil
    import types

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.pytorch import PyTorchTrialContext, Trainer

    ex = torch_trial_example()
    hp = torch_trial_hparams(hparams)
    ckpt_dir = os.path.join(workdir, "torch_trial_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ctx = core.init(max_length=TORCH_TRIAL_STEPS, checkpoint_dir=ckpt_dir)
    trial = ex.GPT2TorchTrial(PyTorchTrialContext(ctx, hp))
    cfg = trial.cfg
    stamps = step_times(trial)
    n_val = len(trial.build_validation_data_loader().get_data_loader())

    # The main path runs from here: every count starts at 0.
    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    fa.reference_attention.calls = 0
    stamps[0] = time.monotonic()
    steps = Trainer(trial, core_context=ctx).fit(
        report_period=TORCH_TRIAL_REPORT)
    torch.cuda.synchronize()
    wall = time.monotonic() - stamps[0]
    launches = {"fwd": fa.flash_fwd_cuda.launches,
                "dq": fa.flash_dq_cuda.launches,
                "dkv": fa.flash_dkv_cuda.launches}
    ref_calls = fa.reference_attention.calls
    losses = report_losses(ctx)
    val = ctx.train.local_validation_metrics
    want = {"fwd": (2 * TORCH_TRIAL_STEPS + n_val) * cfg.n_layer,
            "dq": TORCH_TRIAL_STEPS * cfg.n_layer,
            "dkv": TORCH_TRIAL_STEPS * cfg.n_layer}
    step_ms = steady_step_ms(stamps, TORCH_TRIAL_REPORT)
    tokens_per_s = 8 * 1024 / (step_ms / 1e3)
    say(f"[14a] [{card}] GPT2TorchTrial (GPT-2 small, B 8, S 1024, "
        f"{str(cfg.dtype)[6:]} compute, fp32 params, AdamW lr 3e-4) through "
        f"pytorch.Trainer.fit: {steps} steps in {wall:.1f} s; losses every "
        f"{TORCH_TRIAL_REPORT} steps {[round(x, 4) for x in losses]}; "
        f"validation {val[-1]['metrics'] if val else None}")
    say(f"[14a] flash launches {launches} (expected {want}: phase 7's "
        f"formula, {n_val} validation batches); reference_attention calls "
        f"{ref_calls}")
    if steps != TORCH_TRIAL_STEPS or not finite_and_falling(losses) or \
            len(losses) != TORCH_TRIAL_STEPS // TORCH_TRIAL_REPORT:
        fail(f"14a: the PyTorchTrial did not train: {steps} steps, "
             f"losses {losses}")
    if launches != want or ref_calls != 0:
        fail(f"14a: flash launches {launches} != {want} or plain attention "
             f"calls {ref_calls}")
    phase7 = (f"{train_step_ms:.2f} ms ({8 * 1024 / train_step_ms * 1e3:.0f}"
              f" tokens/s)" if train_step_ms else "not run")
    say(f"[14a] [{card}] fit's step over steps {TORCH_TRIAL_REPORT + 1}-"
        f"{TORCH_TRIAL_STEPS}: {step_ms:.2f} ms, {tokens_per_s:.0f} "
        f"tokens/s; phase 7's Trainer.fit step for the same model: {phase7}")

    (rec,) = ctx.checkpoint.local_reported
    sid = rec["uuid"]
    ctx.close()
    ctx2 = core.init(max_length=TORCH_TRIAL_STEPS, checkpoint_dir=ckpt_dir)
    fresh = ex.GPT2TorchTrial(PyTorchTrialContext(ctx2, dict(hp, seed=1)))
    ctx2.info = types.SimpleNamespace(trial=types.SimpleNamespace(
        latest_checkpoint=sid))
    restored = Trainer(fresh, core_context=ctx2)._restore()
    same = restored == TORCH_TRIAL_STEPS and tensors_equal(
        module_state(fresh.model), module_state(trial.model)) and \
        tensors_equal(fresh.opt.state_dict(), trial.opt.state_dict())
    files = sorted(os.listdir(os.path.join(ckpt_dir, sid)))
    say(f"[14a] checkpoint {sid} ({files}, {rec['metadata']}) restored "
        f"through restore_path into a fresh trial: step {restored}, params "
        f"and AdamW state bitwise equal: {same}")
    ctx2.close()
    if not same or files != ["metadata.json", "state.pt"]:
        fail("14a: the restored trial differs from the trained one")
    del trial, fresh
    _free_cuda()

    # Managed: run A preempted after step 15's report, run B resumed.
    storage = os.path.join(workdir, "torch_trial_managed")
    shutil.rmtree(storage, ignore_errors=True)
    base_env = {
        "DET_TRIAL_ID": str(TORCH_TRIAL_ID), "DET_EXPERIMENT_ID": "1",
        "DET_ALLOCATION_ID": "smoke-alloc-14", "DET_SESSION_TOKEN": "smoke",
        "DET_HPARAMS": json.dumps(hp),
        "DET_EXPERIMENT_CONFIG": json.dumps({"checkpoint_storage": {
            "type": "shared_fs", "host_path": storage}})}

    def run(master, **extra):
        with cluster_env(DET_MASTER=master.url, **base_env, **extra):
            mctx = core.init()
            if mctx.info is None or mctx.checkpoint._session is None:
                fail("14a: core.init() did not take the cluster environment")
            mtrial = ex.GPT2TorchTrial(PyTorchTrialContext(mctx))
            return mctx, mtrial, Trainer(mtrial, core_context=mctx)

    master_a = FakeMaster(TORCH_TRIAL_STEPS,
                          preempt_after=TORCH_TRIAL_PREEMPT_AT)
    t0 = time.monotonic()
    try:
        mctx, mtrial, trainer = run(master_a)
        steps_a = trainer.fit(report_period=TORCH_TRIAL_REPORT)
        params_a = module_state(mtrial.model)
        master_a.release()
        mctx.close()
    finally:
        master_a.close()
    ckpts_a = [(c["uuid"], c["state"], c["steps_completed"])
               for c in master_a.posted("/api/v1/checkpoints")]
    say(f"[14a] managed run A: fit returned at step {steps_a} in "
        f"{time.monotonic() - t0:.1f} s; preemption acked "
        f"{len(master_a.posted('/signals/ack_preemption'))}x; checkpoint "
        f"reports {ckpts_a}; registry {master_a.registry}")
    if steps_a != TORCH_TRIAL_PREEMPT_AT or len(ckpts_a) != 1 or \
            ckpts_a[0][1:] != ("COMPLETED", TORCH_TRIAL_PREEMPT_AT) or \
            master_a.registry != [ckpts_a[0][0]] or \
            not master_a.posted("/signals/ack_preemption") or \
            master_a.posted("/searcher/completed_operation"):
        fail("14a: run A did not stop at the preemption with a registered "
             "checkpoint")
    sid_a = ckpts_a[0][0]

    master_b = FakeMaster(TORCH_TRIAL_STEPS)
    t0 = time.monotonic()
    try:
        mctx, mtrial, trainer = run(master_b, DET_LATEST_CHECKPOINT=sid_a)
        seen = {}
        real_restore = trainer._restore

        def restore():
            seen["step"] = real_restore()
            seen["same"] = tensors_equal(module_state(mtrial.model), params_a)
            return seen["step"]

        trainer._restore = restore
        steps_b = trainer.fit(report_period=TORCH_TRIAL_REPORT)
        master_b.release()
        mctx.close()
    finally:
        master_b.close()
    ckpts_b = [(c["uuid"], c["state"], c["steps_completed"])
               for c in master_b.posted("/api/v1/checkpoints")]
    reported = [b["steps_completed"] for b in master_b.posted("/metrics")
                if b["group"] == "training"]
    ops = master_b.posted("/searcher/completed_operation")
    say(f"[14a] managed run B: restored {sid_a} at step {seen.get('step')}, "
        f"params bitwise equal to run A's: {seen.get('same')}; fit returned "
        f"at step {steps_b} in {time.monotonic() - t0:.1f} s; training "
        f"reports at {reported}; completed op {ops}; checkpoint reports "
        f"{ckpts_b}; registry {master_b.registry}")
    if seen.get("step") != TORCH_TRIAL_PREEMPT_AT or not seen.get("same") \
            or steps_b != TORCH_TRIAL_STEPS or reported != [20, 25, 30] or \
            len(ops) != 1 or ops[0]["length"] != TORCH_TRIAL_STEPS or \
            [c[1:] for c in ckpts_b] != [("COMPLETED", TORCH_TRIAL_STEPS)] or \
            master_b.registry != [ckpts_b[0][0]]:
        fail("14a: run B did not resume from run A's checkpoint and finish")
    del mtrial, trainer
    _free_cuda()
    return {"launches": launches, "step_ms": step_ms,
            "tokens_per_s": tokens_per_s}


def optimizer_states_equal(a, b):
    sa, sb = a.state_dict()["state"], b.state_dict()["state"]
    return sa.keys() == sb.keys() and all(
        tensors_equal(sa[k], sb[k]) for k in sa)


def phase_zero_trial(workdir, hparams, card):
    """14b: the same GPT-2 module as a DeepSpeedTrial on `ZeroOneEngine`
    at world 1 (micro batch 4, gradient accumulation 2) through
    `DeepSpeedTrainer.fit` for 20 steps; an engine step against
    `torch.optim.AdamW` on the same gradients; save_checkpoint and
    load_checkpoint bitwise."""
    import shutil
    import types

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.pytorch import (
        DeepSpeedTrainer, DeepSpeedTrialContext, ZeroOneEngine)

    ex = torch_trial_example()
    hp = torch_trial_hparams(hparams, micro_batch_size=4,
                             gradient_accumulation=2)
    ckpt_dir = os.path.join(workdir, "zero_checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ctx = core.init(max_length=ZERO_STEPS, checkpoint_dir=ckpt_dir)
    trial = ex.GPT2ZeroTrial(DeepSpeedTrialContext(ctx, hp))
    stamps = step_times(trial)
    stamps[0] = time.monotonic()
    steps = DeepSpeedTrainer(trial, core_context=ctx).fit(
        searcher_metric="val_loss", report_period=5)
    wall = time.monotonic() - stamps[0]
    losses = report_losses(ctx)
    eng = trial.engine
    numel = eng.optimizer_state_numel()
    n_params = sum(p.numel() for p in eng._params)
    step_ms = steady_step_ms(stamps, 5)
    files = sorted(os.listdir(os.path.join(
        ckpt_dir, ctx.checkpoint.local_reported[-1]["uuid"])))
    say(f"[14b] [{card}] GPT2ZeroTrial on ZeroOneEngine, world 1, micro "
        f"batch 4 x accumulation 2: {steps} steps in {wall:.1f} s, step "
        f"{step_ms:.2f} ms over steps 6-{ZERO_STEPS}; losses every 5 "
        f"{[round(x, 4) for x in losses]}; optimizer_state_numel {numel:,} "
        f"(2 x {n_params:,} + {len(eng._params)} step counts); checkpoint "
        f"files {files}")
    if steps != ZERO_STEPS or not finite_and_falling(losses) or \
            numel != 2 * n_params + len(eng._params):
        fail(f"14b: the ZeRO-1 trial did not train: {steps} {losses}")

    # save_checkpoint, then load_checkpoint into a fresh engine.
    save_dir = os.path.join(workdir, "zero_engine")
    shutil.rmtree(save_dir, ignore_errors=True)
    eng.save_checkpoint(save_dir, tag="t")
    lr = float(hp["learning_rate"])
    other = ZeroOneEngine(
        ex.GPT2Module(trial.cfg, 1).cuda(),
        lambda p: torch.optim.AdamW(p, lr=lr), micro_batch_size=4,
        gradient_accumulation=2)
    other.load_checkpoint(save_dir, tag="t")
    reloaded = tensors_equal(module_state(other.module),
                             module_state(eng.module)) and \
        optimizer_states_equal(other.optimizer, eng.optimizer)
    ctx.close()
    del trial, eng, other
    _free_cuda()

    # One engine step against AdamW on the same gradients.
    trial_cfg = ex.model_config(hp)
    loader = iter(ex.DataLoader(
        ex.SyntheticTokens(trial_cfg.vocab_size, 1024,
                           path=hp["tokens_path"]),
        batch_size=4).get_data_loader())
    micro = [{k: v.cuda() for k, v in next(loader).items()} for _ in range(2)]
    plain = ex.GPT2Module(trial_cfg, 0).cuda()
    opt = torch.optim.AdamW(plain.parameters(), lr=lr)
    for b in micro:
        (plain(b) / 2).backward()
    grads = [p.grad.clone() for p in plain.parameters()]
    opt.step()
    eng = ZeroOneEngine(ex.GPT2Module(trial_cfg, 0).cuda(),
                        lambda p: torch.optim.AdamW(p, lr=lr),
                        micro_batch_size=4, gradient_accumulation=2)
    for p, g in zip(eng._params, grads):
        p.grad = g.clone()
    eng.step()  # the first micro batch of two: no update
    eng.step()
    same_grads = tensors_equal(module_state(eng.module),
                               module_state(plain)) and \
        optimizer_states_equal(eng.optimizer, opt)
    # The same step through the engine's own backward (information).
    own = ZeroOneEngine(ex.GPT2Module(trial_cfg, 0).cuda(),
                        lambda p: torch.optim.AdamW(p, lr=lr),
                        micro_batch_size=4, gradient_accumulation=2)
    for b in micro:
        own.backward(own(b))
        own.step()
    own_same = tensors_equal(module_state(own.module), module_state(plain))
    say(f"[14b] one engine step against torch.optim.AdamW on the same "
        f"gradients: params and AdamW state bitwise equal: {same_grads}; "
        f"through the engine's own backward of the same micro batches: "
        f"params bitwise equal: {own_same}; save_checkpoint -> "
        f"load_checkpoint into a fresh engine: params and optimizer state "
        f"bitwise equal: {reloaded}")
    if not same_grads or not reloaded:
        fail("14b: the ZeRO-1 engine differs from AdamW or its checkpoint")
    del plain, opt, eng, own
    _free_cuda()
    return {"step_ms": step_ms, "optimizer_state_numel": numel}


# The Blob service's REST subset the port's stdlib client speaks (Put Blob,
# Put Block / Put Block List, Get Blob, List Blobs, Delete Blob), every
# request's SharedKey signature recomputed: chip_smoke's own copy of the
# tests' fake.
BLOB_ACCOUNT = "smokeacct"
BLOB_KEY = "MDEyMzQ1Njc4OWFiY2RlZjAxMjM0NTY3ODlhYmNkZWY="


def fake_blob_service():
    """-> (server, endpoint, store, auth failures)."""
    import base64
    import hashlib
    import hmac
    import xml.etree.ElementTree as ET
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    store, blocks, bad = {}, {}, []

    class Blob(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _check(self, length):
            url = urllib.parse.urlsplit(self.path)
            query = dict(urllib.parse.parse_qsl(url.query))
            res = f"/{BLOB_ACCOUNT}{url.path}" + "".join(
                f"\n{k.lower()}:{query[k]}" for k in sorted(query))
            ms = "".join(f"{k}:{v}\n" for k, v in sorted(
                (k.lower(), v.strip()) for k, v in self.headers.items()
                if k.lower().startswith("x-ms-")))
            h = self.headers
            sts = "\n".join([
                self.command, h.get("Content-Encoding", ""),
                h.get("Content-Language", ""), str(length) if length else "",
                h.get("Content-MD5", ""), h.get("Content-Type", ""), "",
                h.get("If-Modified-Since", ""), h.get("If-Match", ""),
                h.get("If-None-Match", ""), h.get("If-Unmodified-Since", ""),
                h.get("Range", "")]) + "\n" + ms + res
            sig = base64.b64encode(hmac.new(
                base64.b64decode(BLOB_KEY), sts.encode(),
                hashlib.sha256).digest()).decode()
            if h.get("Authorization") != f"SharedKey {BLOB_ACCOUNT}:{sig}":
                bad.append(f"{self.command} {self.path}")
            return url, query

        def _name(self, url):
            container, _, name = url.path.strip("/").partition("/")
            return container, urllib.parse.unquote(name)

        def _send(self, status, body=b""):
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def do_PUT(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            url, query = self._check(n)
            body = self.rfile.read(n)
            key = self._name(url)
            if query.get("comp") == "block":
                blocks[key + (query["blockid"],)] = body
            elif query.get("comp") == "blocklist":
                ids = [e.text for e in ET.fromstring(body).iter("Latest")]
                store[key] = b"".join(blocks.pop(key + (i,)) for i in ids)
            else:
                store[key] = body
            self._send(201)

        def do_GET(self):  # noqa: N802
            url, query = self._check(0)
            if query.get("comp") == "list":
                container, prefix = url.path.strip("/"), query.get(
                    "prefix", "")
                blobs = "".join(
                    f"<Blob><Name>{n}</Name><Properties><Content-Length>"
                    f"{len(b)}</Content-Length></Properties></Blob>"
                    for (c, n), b in sorted(store.items())
                    if c == container and n.startswith(prefix))
                self._send(200, ("<?xml version='1.0'?><EnumerationResults>"
                                 f"<Blobs>{blobs}</Blobs><NextMarker/>"
                                 "</EnumerationResults>").encode())
                return
            data = store.get(self._name(url))
            self._send(404) if data is None else self._send(200, data)

        def do_DELETE(self):  # noqa: N802
            url, _ = self._check(0)
            store.pop(self._name(url), None)
            self._send(202)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Blob)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}", store, bad


def save_restore_times(ctx, state, step):
    """save_state (async) -> wait -> verify -> restore_state on `ctx`:
    -> (storage id, sync ms, wait ms, restore ms, restored bitwise)."""
    import torch

    t0 = time.monotonic()
    sid = ctx.save_state(state, steps_completed=step)
    sync_ms = (time.monotonic() - t0) * 1e3
    t1 = time.monotonic()
    ctx.wait()
    wait_ms = (time.monotonic() - t1) * 1e3
    if ctx.verify(sid) is not True:
        fail(f"14c: {sid} did not verify")
    t2 = time.monotonic()
    back = ctx.restore_state(sid, state)
    restore_ms = (time.monotonic() - t2) * 1e3
    got, want = state_tensors(back), state_tensors(state)
    same = len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    return sid, sync_ms, wait_ms, restore_ms, same


def phase_remote_storage(workdir, hparams, card):
    """14c: GPT-2 small's TrainState from the port's Trainer (params and
    Adam moments after one step) through `CheckpointContext` into
    `checkpoint_storage: {type: azure}` against an in-process fake Blob
    service: save_state -> wait -> verify -> restore_state bitwise, then
    the file-checkpoint calls on the same backend; shared_fs timed the
    same way; gcs and s3 where their SDKs import."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.core import _integrity
    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.storage import from_config
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    ctx = core.init(max_length=1,
                    checkpoint_dir=os.path.join(workdir, "remote_unused"))
    trainer = Trainer(GPT2Trial(TrialContext(hparams=hparams,
                                             core_context=ctx)),
                      core_context=ctx)
    trainer._build(SEED)
    tokens = np.memmap(hparams["tokens_path"], dtype=np.int32, mode="r")
    batch = {"tokens": torch.from_numpy(np.stack(
        [tokens[i * 1025:(i + 1) * 1025] for i in range(8)])).cuda()}
    state, _ = trainer._train_step(
        trainer.state, batch, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in state_tensors(state))
    ctx.close()

    server, url, store, bad = fake_blob_service()
    staging = tempfile.mkdtemp(dir=workdir)
    saved_tmp = tempfile.tempdir
    tempfile.tempdir = staging  # the cloud staging lives under build/smoke
    try:
        azure = from_config({
            "type": "azure", "container": "ckpts", "prefix": "smoke",
            "connection_string": f"AccountName={BLOB_ACCOUNT};AccountKey="
                                 f"{BLOB_KEY};BlobEndpoint={url}"})
        remote = CheckpointContext(azure, trial_id=TORCH_TRIAL_ID,
                                   async_save=True)
        sid, sync_ms, wait_ms, restore_ms, same = save_restore_times(
            remote, state, 1)
        listing = azure.list_files(sid)
        stored = sum(listing.values())
        say(f"[14c] [{card}] azure (fake Blob service, in process): "
            f"save_state of the TrainState ({n_bytes / 1e6:.1f} MB of "
            f"tensors, {stored / 1e6:.1f} MB stored in {len(listing)} "
            f"blobs) sync {sync_ms:.1f} ms, wait {wait_ms:.1f} ms (write, "
            f"upload, manifest, COMMIT): upload "
            f"{stored / 1e6 / ((sync_ms + wait_ms) / 1e3):.1f} MB/s; "
            f"restore_state {restore_ms:.1f} ms "
            f"({stored / 1e6 / (restore_ms / 1e3):.1f} MB/s), bitwise "
            f"equal: {same}; verify True; staging left: "
            f"{os.path.exists(azure.path_for(sid))}")
        if not same or sorted(listing) != sorted(
                [_integrity.COMMIT_FILE, _integrity.MANIFEST_FILE,
                 "metadata.json", "state/state.pt"]) or \
                os.path.exists(azure.path_for(sid)):
            fail(f"14c: the azure checkpoint did not round-trip: {listing}")

        # The file-checkpoint calls on the same backend.
        payload = os.urandom(10 << 20)
        with remote.store_path({"steps_completed": 1}) as (path, fid):
            with open(os.path.join(path, "weights.bin"), "wb") as f:
                f.write(payload)
            with open(os.path.join(path, "notes.txt"), "w") as f:
                f.write("smoke")
        with remote.restore_path(fid) as path:
            with open(os.path.join(path, "weights.bin"), "rb") as f:
                restored_file = f.read() == payload
        picked = os.path.join(staging, "picked")
        remote.download(fid, picked, selector=lambda rel: rel == "notes.txt")
        md = remote.load_metadata(fid)
        remote.delete(fid)
        ok = restored_file and os.listdir(picked) == ["notes.txt"] and \
            md.get("steps_completed") == 1 and azure.list_files(fid) == {} \
            and [r["uuid"] for r in remote.local_reported] == [sid, fid]
        say(f"[14c] azure file checkpoints: store_path -> restore_path "
            f"(10 MB file bitwise: {restored_file}), download with a "
            f"selector {os.listdir(picked)}, load_metadata {md}, delete "
            f"(left {azure.list_files(fid)}); signature failures {len(bad)}")
        if not ok or bad:
            fail("14c: the azure file checkpoints did not round-trip")
        shutil.rmtree(picked, ignore_errors=True)
    finally:
        tempfile.tempdir = saved_tmp
        server.shutdown()
        server.server_close()
        store.clear()
        shutil.rmtree(staging, ignore_errors=True)

    shared_dir = os.path.join(workdir, "remote_shared_fs")
    shutil.rmtree(shared_dir, ignore_errors=True)
    shared = CheckpointContext(from_config(
        {"type": "shared_fs", "host_path": shared_dir}),
        trial_id=TORCH_TRIAL_ID, async_save=True)
    sid, s_sync, s_wait, s_restore, s_same = save_restore_times(
        shared, state, 1)
    s_bytes = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(os.path.join(shared_dir, sid))
                  for f in fs)
    say(f"[14c] [{card}] shared_fs: save_state sync {s_sync:.1f} ms, wait "
        f"{s_wait:.1f} ms (write, sha256 manifest, COMMIT): "
        f"{s_bytes / 1e6 / ((s_sync + s_wait) / 1e3):.1f} MB/s; "
        f"restore_state {s_restore:.1f} ms "
        f"({s_bytes / 1e6 / (s_restore / 1e3):.1f} MB/s), bitwise equal: "
        f"{s_same}")
    if not s_same:
        fail("14c: the shared_fs checkpoint did not round-trip")
    shutil.rmtree(shared_dir, ignore_errors=True)

    for stype, package in (("gcs", "google-cloud-storage"),
                           ("s3", "boto3")):
        try:
            from_config({"type": stype, "bucket": "smoke"})
        except RuntimeError as e:
            if package not in str(e):
                fail(f"14c: {stype} raised without naming {package}: {e}")
            say(f"[14c] {stype} not run: {e}")
            continue
        say(f"[14c] {stype} not run: its SDK imports on this host, and "
            "this script carries no fake server for it")
    del trainer, state
    _free_cuda()
    return {"azure": {"sync_ms": sync_ms, "wait_ms": wait_ms,
                      "restore_ms": restore_ms, "bytes": stored},
            "shared_fs": {"sync_ms": s_sync, "wait_ms": s_wait,
                          "restore_ms": s_restore, "bytes": s_bytes}}


def phase_torch_trials(workdir, hparams, card, train_step_ms=None):
    """Phase 14, each sub-phase's wall time printed."""
    times = {}
    for name, fn in (
            ("14a", lambda: phase_torch_trial(workdir, hparams, card,
                                              train_step_ms)),
            ("14b", lambda: phase_zero_trial(workdir, hparams, card)),
            ("14c", lambda: phase_remote_storage(workdir, hparams, card))):
        t0 = time.monotonic()
        times[name] = (fn(), time.monotonic() - t0)
        say(f"[{name}] wall {times[name][1]:.1f} s")
    return {k: v[0] for k, v in times.items()}


FLASH_KERNELS = (  # (key, name, TPU kernel it replaces)
    ("fwd", "flash_fwd", "determined_tpu/ops/flash_attention.py:137"),
    ("dq", "flash_dq", "determined_tpu/ops/flash_attention.py:245"),
    ("dkv", "flash_dkv", "determined_tpu/ops/flash_attention.py:293"))


# ----------------------------------------------------------------- phase 15


def resnet50_trial_class():
    """13b's model, optimizer and batch as a stateful TorchTrial, which is
    what the preflight reads (13b drives `make_train_step` with the same
    pieces). The loader yields host batches of 13b's shapes and dtypes."""
    import torch

    from determined_tpu_torch.models import resnet
    from determined_tpu_torch.train import TorchTrial, optim

    class ResNet50Trial(TorchTrial):
        stateful = True
        cfg = resnet.Config.resnet50()

        def init_params(self, rng):
            return resnet.init(rng, self.cfg)[0]

        def init_extra(self):
            return resnet.init_stats(self.cfg)

        def loss(self, params, extra, batch, rng):
            return resnet.loss_fn(params, extra, batch, rng, self.cfg)

        def optimizer(self):
            return optim.sgd(0.1, momentum=0.9)

        def build_training_data(self):
            b = self.context.global_batch_size
            while True:
                yield {"images": torch.zeros((b, 224, 224, 3),
                                             dtype=torch.bfloat16),
                       "labels": torch.zeros((b,), dtype=torch.int32)}

    return ResNet50Trial


PREFLIGHT_KEYS = (("params", "params_bytes"),
                  ("opt_state", "opt_state_bytes"),
                  ("grads", "grads_bytes"), ("batch", "batch_bytes"),
                  ("activations", "activations_upper_bound_bytes"),
                  ("total", "total_bytes"))


def phase_preflight(hparams, long, r50, card):
    """15a-15c: the port's preflight held to the card's own peaks."""
    import torch

    from determined_tpu_torch.analysis import analyze_trial
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.ops import paged_attention as pa
    from determined_tpu_torch.train.trial import TrialContext

    GPT2Trial = gpt2_trial_class()
    cases = (("12a", lambda b: GPT2Trial(TrialContext(hparams={
        **long_hparams(hparams), "global_batch_size": b})), LONG_BATCH,
        long["peak_gib"]),
             ("13b", lambda b: resnet50_trial_class()(TrialContext(
                 hparams={"global_batch_size": b})), RESNET50_BATCH,
              r50["peak_gib"]))
    wrappers = {"flash_fwd": fa.flash_fwd_cuda, "flash_dq": fa.flash_dq_cuda,
                "flash_dkv": fa.flash_dkv_cuda,
                "paged": pa.paged_attention_cuda}
    _free_cuda()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = {k: f.launches for k, f in wrappers.items()}

    # 15a: the estimate against the measured peak.
    out, wall_ms = {}, {}
    for name, make, batch, peak_gib in cases:
        t0 = time.perf_counter()
        diags, hbm, notes = analyze_trial(make(batch), 1)
        wall_ms[name] = (time.perf_counter() - t0) * 1e3
        gib = {k: hbm.get(key, 0) / 2 ** 30 for k, key in PREFLIGHT_KEYS}
        say(f"[15a] [{card}] {name} (B {batch}) estimate per device, GiB: "
            + ", ".join(f"{k} {v:.4f}" for k, v in gib.items())
            + f"; measured peak {peak_gib:.4f} GiB "
            f"(max_memory_allocated); analysis {wall_ms[name]:.1f} ms")
        active = [d.code for d in diags if not d.suppressed]
        if active or notes or "activations_upper_bound_bytes" not in hbm:
            fail(f"15a: {name}'s analysis reported {active}, notes {notes}")
        low, high = gib["total"], gib["total"] + gib["activations"]
        if not low <= peak_gib <= high:
            fail(f"15a: {name}'s peak {peak_gib:.4f} GiB is outside the "
                 f"estimate's bracket [{low:.4f}, {high:.4f}] GiB")
        say(f"[15a] {name}: total {low:.4f} <= peak {peak_gib:.4f} <= total "
            f"+ activations {high:.4f} GiB; the peak is "
            f"{(peak_gib - low) / (high - low) * 100:.1f}% of the way from "
            "the lower end to the upper")
        out[name] = {"gib": gib, "peak_gib": peak_gib}
    # 12a at B 8 runs out of memory on one card (LONG_BATCH's comment).
    _, hbm8, _ = analyze_trial(cases[0][1](2 * LONG_BATCH), 1)
    total_mem = torch.cuda.get_device_properties(0).total_memory
    say(f"[15a] [{card}] 12a at B {2 * LONG_BATCH} (information): total "
        f"{hbm8['total_bytes'] / 2 ** 30:.4f} GiB, total + activations "
        f"{(hbm8['total_bytes'] + hbm8['activations_upper_bound_bytes']) / 2 ** 30:.4f}"
        f" GiB, the card's memory {total_mem / 2 ** 30:.4f} GiB")
    out["12a_b8"] = {k: hbm8.get(key, 0) / 2 ** 30 for k, key in
                     PREFLIGHT_KEYS}

    # 15b: no device work.
    torch.cuda.synchronize()
    moved = {k: f.launches - launches[k] for k, f in wrappers.items()}
    now, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    say(f"[15b] [{card}] around the analyses: memory_allocated {allocated} "
        f"-> {now} bytes, max_memory_allocated {peak}; launches moved "
        f"{moved}; GPT-2 small analysis wall {wall_ms['12a']:.1f} ms, "
        f"ResNet-50 {wall_ms['13b']:.1f} ms (host time)")
    if now != allocated or peak != allocated or any(moved.values()):
        fail("15b: the analyses allocated device memory or launched a "
             "kernel")

    # 15c: the fixtures through the entry point, no JAX on this host.
    fixtures = os.path.join(ROOT, "tests", "fixtures", "preflight_torch")
    want = {"bad": (1, ["DTL002", "DTL101"]), "clean": (0, [])}
    t0 = time.monotonic()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "determined_tpu_torch.analysis", "preflight",
         os.path.join(fixtures, name, "config.json"),
         os.path.join(fixtures, name), "--json"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in want}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        try:
            got = (proc.returncode,
                   json.loads(stdout)["summary"]["codes"])
        except ValueError:
            fail(f"15c: {name}: no JSON report (rc {proc.returncode}): "
                 f"{stderr[-2000:]}")
        say(f"[15c] {name} fixture: exit {got[0]}, codes {got[1]} "
            f"(expected {want[name]})")
        if got != want[name]:
            fail(f"15c: the {name} fixture gave {got}, want {want[name]}")
    say(f"[15c] both fixtures in {time.monotonic() - t0:.1f} s")
    out["wall_ms"] = wall_ms
    return out


# ----------------------------------------------------------------- phase 16


# examples/gpt2_cuda/pipeline.yaml's model and layout: GPT-2 small at S
# 1024 in bf16 with phase 7's remat ("dots"), 2 GPipe stages x (data 2 x
# fsdp 2) over 8 slots, a global batch of 128: one batch shard holds 128
# / (data 2 x fsdp 2) = 32 rows, which every stage of its pipeline group
# runs. 16a walks 2 and 4 stages of that shard in one process, with the
# microbatch count `pipeline_microbatches_default` gives that mesh (8 at
# 2 stages, 16 at 4).
PIPE_MESH = {"data": 2, "fsdp": 2}
PIPE_BATCH = 32
PIPE_STAGES = (2, 4)
PIPE_FP32_BATCH = 8
# 16a's limits on the walked schedule against `gpt2.loss_fn`, each
# gradient leaf as max |walk - plain| / max |plain|. fp32 (the FFMA
# kernels, TF32 off): the walk runs the same arithmetic on smaller
# products, so only cuBLAS's choice of kernel for another row count moves
# a sum's order: 1e-5 of each leaf's largest element, the loss rtol 1e-5.
PIPE_FP32_TOL = 1e-5
# bf16: each product rounds its output to bf16, so another kernel choice
# for a microbatch's rows moves a value by a rounding, and 12 layers and
# the backward carry it on. PIPE_BF16_TOL = (loss rtol, a leaf's
# gradient as above), set from a calibration run of this phase on an
# H100 (PERF.md): the loss came out bitwise at 2 and 4 stages, the
# worst leaf 3.564e-3 (2 stages) and 3.210e-3 (4 stages) of its largest
# element; the limits are about three times that. The planted faults
# moved a leaf by 1.52 and 1.41 of its largest element, the loss by
# 1.2e-4 and 2.2e-4.
PIPE_BF16_TOL = (1e-4, 1e-2)
# 16c's routing: a chunk's slots (pos, kept), its chosen experts and the
# capacity must be bitwise the whole route's. Its router product runs on
# T / c rows, and cuBLAS reduces the 768-long fp32 dot products of
# another row count in another order (a first run of this phase on an
# H100: probabilities and gates not bitwise, the slots and choices
# were; a second read 2.98e-7 and 2.68e-7 at 2 and 4 chunks), so the
# gates and probabilities (values at most 1) are held to MOE_GATE_ATOL.
MOE_GATE_ATOL = 1e-6
# 16c's bf16 limit on the experts' FFN split over tensor 2 (two halves
# summed in bf16, the `down` bias once) against the unsplit FFN, as max
# |split - whole| / max |whole|: each half rounds its product to bf16
# before the sum, where the whole rounds once. Two runs of this phase on
# an H100 (PERF.md) read 5.587e-3; the limit is about 3.6 times
# that (fp32 read 2.211e-6 against MOE_TENSOR_FP32_TOL).
MOE_TENSOR_BF16_TOL = 2e-2
MOE_TENSOR_FP32_TOL = 1e-5


def pipe_microbatches(stages, batch):
    """`pipeline_microbatches_default` of pipeline.yaml's mesh at `stages`
    stages, for one batch shard of `batch` rows."""
    from determined_tpu_torch.parallel import pipeline
    from determined_tpu_torch.parallel.mesh import MeshConfig

    mesh = MeshConfig(pipeline=stages, **PIPE_MESH)
    return pipeline.pipeline_microbatches_default(
        mesh, batch * pipeline._batch_shards(mesh, None))


def pipe_walk(stages, **faults):
    """A `schedule` for `gpt2.loss_fn_pipelined`: `pipeline.walk` over
    `stages` stages in one process (`faults`: its `commit` and
    `slices`)."""
    from determined_tpu_torch.parallel import pipeline

    def schedule(block, blocks, x, m):
        return pipeline.walk(block, blocks, x, stages, m, **faults)

    return schedule


def pipe_step(leaves, names, batch, cfg, schedule=None, m=None):
    """loss and every leaf's gradient: `gpt2.loss_fn`, or with `schedule`
    the pipelined loss walked over its stages."""
    import torch

    from determined_tpu_torch.models import gpt2

    params = gpt2._unflatten(dict(zip(names, leaves)))
    if schedule is None:
        loss = gpt2.loss_fn(params, batch, cfg)
    else:
        loss = gpt2.loss_fn_pipelined(params, batch, cfg, None,
                                      num_microbatches=m, schedule=schedule)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss), grads


def pipe_errors(got, want, names):
    """(the loss's relative error, the worst leaf's max |diff| / max
    |plain| and its name)."""
    loss_rel = abs(got[0] - want[0]) / abs(want[0])
    name, rel = max(((n, float((g.float() - w.float()).abs().max()
                               / w.float().abs().max()))
                     for n, g, w in zip(names, got[1], want[1])),
                    key=lambda kv: kv[1])
    return loss_rel, rel, name


def flash_counts(reset=False):
    from determined_tpu_torch.ops import flash_attention as fa

    fns = {"fwd": fa.flash_fwd_cuda, "dq": fa.flash_dq_cuda,
           "dkv": fa.flash_dkv_cuda}
    out = {k: f.launches for k, f in fns.items()}
    if reset:
        for f in fns.values():
            f.launches = 0
    return out


def phase_pipeline_walk(card):
    """16a: pipeline.yaml's model (GPT-2 small, S 1024, bf16, remat "dots",
    random weights from a seed) on one batch shard of B 32: the GPipe
    schedule walked in one process at 2 and 4 stages
    (`gpt2.loss_fn_pipelined` with `pipeline.walk`), its loss and every
    gradient against `gpt2.loss_fn` on the same batch, within
    PIPE_BF16_TOL; the same in fp32 at B 8 within PIPE_FP32_TOL. Each
    flash kernel must launch M times what the plain step launches for the
    same layers. Two planted faults (a microbatch committed one tick
    late, the two stages' layer slices swapped) must be refused. Prints
    the walked step's ms at 2 stages against the plain step's, in turns.
    -> the launches of the 2-stage bf16 step."""
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.parallel import pipeline

    cfg = dataclasses.replace(gpt2.Config.small(), attention_impl="kernel")
    flat = gpt2._flatten(gpt2.init(
        torch.Generator(device="cuda").manual_seed(SEED + 70), cfg))
    names = list(flat)
    leaves = [t.requires_grad_() for t in flat.values()]
    tokens = torch.from_numpy(np.random.default_rng(SEED + 71).integers(
        0, cfg.vocab_size, (PIPE_BATCH, 1025)).astype(np.int32)).cuda()
    batch = {"tokens": tokens}
    fa.reference_attention.calls = 0
    flash_counts(reset=True)
    plain = pipe_step(leaves, names, batch, cfg)
    torch.cuda.synchronize()
    per_step = flash_counts(reset=True)
    L = cfg.n_layer
    if per_step != {"fwd": 2 * L, "dq": L, "dkv": L}:
        fail(f"the plain step launched {per_step}, want phase 7's "
             f"{ {'fwd': 2 * L, 'dq': L, 'dkv': L} }")
    out = {"launches": None}
    for stages in PIPE_STAGES:
        m = pipe_microbatches(stages, PIPE_BATCH)
        # The main path of this slice: every count starts at 0.
        flash_counts(reset=True)
        walked = pipe_step(leaves, names, batch, cfg, pipe_walk(stages), m)
        torch.cuda.synchronize()
        launches = flash_counts(reset=True)
        want = {k: m * v for k, v in per_step.items()}
        loss_rel, rel, worst = pipe_errors(walked, plain, names)
        say(f"[pipeline] [{card}] bf16 B {PIPE_BATCH}, {stages} stages, M "
            f"{m} (bubble (S-1)/(M+S-1) = {(stages - 1) / (m + stages - 1):.3f}"
            f"), walked against loss_fn: loss {walked[0]:.6f} / "
            f"{plain[0]:.6f} (rel {loss_rel:.2e}, limit "
            f"{PIPE_BF16_TOL[0]:g}); worst gradient leaf {worst} "
            f"{rel:.3e} of its largest element (limit {PIPE_BF16_TOL[1]:g});"
            f" flash launches {launches} (want M x the plain step's "
            f"{per_step})")
        if launches != want:
            fail(f"16a at {stages} stages launched {launches}, want {want}")
        if loss_rel > PIPE_BF16_TOL[0] or rel > PIPE_BF16_TOL[1]:
            fail(f"16a: the walked schedule at {stages} stages differs from "
                 f"loss_fn in bf16 (loss {loss_rel:.2e}, {worst} {rel:.2e})")
        if stages == 2:
            out["launches"] = launches
            out["m"] = m
        del walked
    if fa.reference_attention.calls:
        fail(f"the plain attention ran {fa.reference_attention.calls} "
             "times in 16a")
    # The planted faults, at 2 stages.
    m = pipe_microbatches(2, PIPE_BATCH)
    for name, faults in (
            ("a microbatch committed one tick late", {
                "commit": lambda t, s, mm: (
                    pipeline.commit_slot(t, s, mm) + 1) % mm}),
            ("the two stages' layer slices swapped", {"slices": [1, 0]})):
        wrong = pipe_step(leaves, names, batch, cfg, pipe_walk(2, **faults),
                          m)
        loss_rel, rel, worst = pipe_errors(wrong, plain, names)
        refused = loss_rel > PIPE_BF16_TOL[0] or rel > PIPE_BF16_TOL[1]
        say(f"[pipeline] planted fault '{name}': loss rel {loss_rel:.2e}, "
            f"worst leaf {worst} {rel:.3e}: refused {refused}")
        if not refused:
            fail(f"16a's checks pass the planted fault '{name}'")
        del wrong
    flash_counts(reset=True)
    # The step's time, in turns: plain, walked, walked, plain.
    ms = {"plain": [], "walked": []}
    for kind in ("plain", "walked", "walked", "plain"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if kind == "plain":
            pipe_step(leaves, names, batch, cfg)
        else:
            pipe_step(leaves, names, batch, cfg, pipe_walk(2), m)
        torch.cuda.synchronize()
        ms[kind].append((time.monotonic() - t0) * 1e3)
    # Their device time under torch.profiler: what the card works.
    out["device_ms"] = {
        "plain": device_ms_per_step(
            lambda: pipe_step(leaves, names, batch, cfg), 1),
        "walked": device_ms_per_step(
            lambda: pipe_step(leaves, names, batch, cfg, pipe_walk(2), m),
            1)}
    flash_counts(reset=True)
    out["ms"] = {k: statistics.mean(v) for k, v in ms.items()}
    say(f"[pipeline] [{card}] the step (loss and gradients) at B "
        f"{PIPE_BATCH}, in turns: walked over 2 stages (M {m}) "
        f"{' / '.join(f'{x:.2f}' for x in ms['walked'])} ms, plain "
        f"{' / '.join(f'{x:.2f}' for x in ms['plain'])} ms: walked "
        f"{out['ms']['walked'] / out['ms']['plain']:.3f}x plain; device "
        f"time under torch.profiler: walked "
        f"{out['device_ms']['walked']:.2f} ms, plain "
        f"{out['device_ms']['plain']:.2f} ms")
    del plain, leaves, flat
    _free_cuda()
    # fp32 at B 8.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    flat = gpt2._flatten(gpt2.init(
        torch.Generator(device="cuda").manual_seed(SEED + 70), cfg32))
    leaves = [t.requires_grad_() for t in flat.values()]
    batch = {"tokens": tokens[:PIPE_FP32_BATCH]}
    plain = pipe_step(leaves, names, batch, cfg32)
    for stages in PIPE_STAGES:
        m = pipe_microbatches(stages, PIPE_FP32_BATCH)
        walked = pipe_step(leaves, names, batch, cfg32, pipe_walk(stages), m)
        loss_rel, rel, worst = pipe_errors(walked, plain, names)
        say(f"[pipeline] [{card}] fp32 B {PIPE_FP32_BATCH}, {stages} stages, "
            f"M {m}: loss rel {loss_rel:.2e}, worst gradient leaf {worst} "
            f"{rel:.3e} of its largest element (limit {PIPE_FP32_TOL:g})")
        if loss_rel > PIPE_FP32_TOL or rel > PIPE_FP32_TOL:
            fail(f"16a: the walked schedule at {stages} stages differs from "
                 f"loss_fn in fp32 (loss {loss_rel:.2e}, {worst} {rel:.2e})")
    flash_counts(reset=True)
    del plain, walked, leaves, flat
    _free_cuda()
    return out


def phase_moe_chunks(card):
    """16c: moe.yaml's model (GPT-2 small, 8 experts, top-2, bf16, random
    weights from a seed) at B 8, S 1024: the first MoE block's input,
    routed by `ops.moe.route` over 2 and 4 context chunks of each row in
    turn, each chunk fed the per-row counts of every chunk (what the
    context group's all-gather delivers), against one route over the
    whole: pos, kept, the chosen experts and the capacity bitwise, the
    gates and probabilities within MOE_GATE_ATOL, the aux loss within
    1e-6 relative. Then the experts' FFN on
    the whole route's slots split over tensor 2 (two halves of `up`'s
    columns and `down`'s rows, summed, the `down` bias once) against the
    unsplit FFN: fp32 within MOE_TENSOR_FP32_TOL of the largest element,
    bf16 within MOE_TENSOR_BF16_TOL."""
    import dataclasses

    import numpy as np
    import torch

    from determined_tpu_torch.models import gpt2
    from determined_tpu_torch.ops import moe

    cfg = dataclasses.replace(gpt2.Config.small(), attention_impl="kernel",
                              **MOE_HPARAMS)
    params = gpt2.init(torch.Generator(device="cuda").manual_seed(SEED + 72),
                       cfg)
    b, s = 8, 1024
    tokens = torch.from_numpy(np.random.default_rng(SEED + 73).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    seen, block = [], moe.moe_block

    def first_input(x, *args, **kwargs):
        if not seen:
            seen.append(x.detach().clone())
        return block(x, *args, **kwargs)

    moe.moe_block = first_input
    try:
        with torch.no_grad():
            gpt2.apply(params, tokens, cfg)
    finally:
        moe.moe_block = block
    x = seen[0]
    e, k, cf = cfg.num_experts, cfg.moe_top_k, cfg.moe_capacity_factor
    lp = gpt2.map_params(lambda t: t[0], params["blocks"]["moe"])
    router = lp["router"]["kernel"]
    xt = x.reshape(-1, x.shape[-1])
    whole = moe.route(xt, router, e, k, cf, rows=b)
    for chunks in (2, 4):
        parts = list(x.chunk(chunks, dim=1))
        alone = [moe.route(p.reshape(-1, p.shape[-1]), router, e, k, cf,
                           rows=b) for p in parts]
        counts = torch.stack([moe.row_counts(r.gate_idx, e, b)
                              for r in alone])[None]
        walked = [moe.route(p.reshape(-1, p.shape[-1]), router, e, k, cf,
                            moe.chunk_place(j, chunks), rows=b,
                            counts=counts)
                  for j, p in enumerate(parts)]

        def merged(field):
            return torch.cat([getattr(r, field).reshape(b, s // chunks, -1)
                              for r in walked], dim=1).reshape(b * s, -1)

        same = {f: torch.equal(merged(f), getattr(whole, f))
                for f in ("pos", "kept", "gate_idx", "gate_vals", "probs")}
        gate_err = max(float((merged(f) - getattr(whole, f)).abs().max())
                       for f in ("gate_vals", "probs"))
        caps = sorted({r.capacity for r in walked})
        aux = [float(moe._aux_loss(r, e, None)) for r in (whole, moe.Routing(
            merged("probs"), merged("gate_idx"), merged("gate_vals"),
            merged("pos"), merged("kept"), whole.capacity))]
        aux_rel = abs(aux[1] - aux[0]) / abs(aux[0])
        kept = float(whole.kept.float().mean())
        say(f"[moe-chunks] [{card}] bf16 B {b} S {s}, {chunks} context "
            f"chunks against one route: bitwise {same}; gates and "
            f"probabilities max |diff| {gate_err:.2e} (limit "
            f"{MOE_GATE_ATOL:g}); capacity {caps} / {whole.capacity}; aux "
            f"{aux[1]:.8f} / {aux[0]:.8f} (rel {aux_rel:.2e}, limit 1e-6); "
            f"kept share {kept:.4f}")
        slots = ("pos", "kept", "gate_idx")
        if not all(same[f] for f in slots) or caps != [whole.capacity] or \
                gate_err > MOE_GATE_ATOL or aux_rel > 1e-6:
            fail(f"16c: routing over {chunks} context chunks differs from "
                 f"one route over the whole: {same}, gates {gate_err:.2e}, "
                 f"capacity {caps}, aux rel {aux_rel:.2e}")
    # The experts over tensor 2, on the whole route's slots.
    _, xe = moe.dispatch(xt, whole, 0, e)
    f = lp["up"]["kernel"].shape[-1]
    halves = [{"up": {"kernel": lp["up"]["kernel"][..., i * f // 2:
                                                   (i + 1) * f // 2],
                      "bias": lp["up"]["bias"][..., i * f // 2:
                                               (i + 1) * f // 2]},
               "down": {"kernel": lp["down"]["kernel"][:, i * f // 2:
                                                       (i + 1) * f // 2]}}
              for i in range(2)]
    for dtype, tol in ((torch.float32, MOE_TENSOR_FP32_TOL),
                       (torch.bfloat16, MOE_TENSOR_BF16_TOL)):
        xd = xe.to(dtype)
        with torch.no_grad():
            full = moe.expert_ffn(xd, lp)
            split = sum(moe.expert_ffn_part(xd, h) for h in halves) + \
                lp["down"]["bias"].to(dtype)[:, None, :]
        rel = float((split.float() - full.float()).abs().max()
                    / full.float().abs().max())
        say(f"[moe-chunks] [{card}] {str(dtype)[6:]} experts' FFN over "
            f"tensor 2 (halves summed, bias once) against the unsplit FFN: "
            f"max |diff| / max |x| {rel:.3e} (limit {tol:g})")
        if rel > tol:
            fail(f"16c: the experts' FFN split over tensor 2 differs from "
                 f"the unsplit one in {str(dtype)[6:]}: {rel:.3e}")
    del params, x, xe
    _free_cuda()


def world_against_one(workdir, hparams, tag, name, extra, card, trial_id,
                      entry=GPT2_ENTRY, repeat=False):
    """The trial of `entry` (launch_trial's) at world 2 over NCCL (the
    mesh `extra` names, `name: 2`) through the GPU-slot launcher, against
    a world of one at
    the same hparams: the losses and grad norms of each report window
    within SPLIT_LOSS_RTOL and SPLIT_NORM_RTOL. `repeat` runs world 1 a
    second time and prints its distance from the first (the run-to-run
    spread the world 2 distance is read against; no limit). -> (the
    relative differences, each world's step of the last report window,
    each rank's peak memory in GiB)."""
    reports, step_ms, peaks = {}, {}, {}
    runs = ((1, "[0]", 1), (2, "[0,1]", 2)) + (
        ((1, "[0]", "again"),) if repeat else ())
    for nproc, slots, key in runs:
        mesh = {**extra["mesh"], name: nproc}
        storage = os.path.join(workdir, f"split_{tag}_{name}_{key}")
        results, master, rc, log = launch_trial(
            workdir, {**hparams, **extra, "mesh": mesh}, storage, nproc,
            slots, trial_id=trial_id + len(reports) + 1, timeout=300,
            entry=entry)
        if rc != 0 or sorted(results) != list(range(nproc)):
            say(log[-3000:])
            fail(f"{tag} {name} at world {nproc} exited {rc}")
        reports[key] = [
            b["metrics"] for b in master.posted("/metrics")
            if b["group"] == "training" and "loss" in b["metrics"]]
        # Fit replays its step at every width: the first flush says so.
        if reports[key][0].get("step_captured") != 1.0:
            fail(f"{tag} {name} at world {nproc}: the first flush reads "
                 f"step_captured {reports[key][0].get('step_captured')}, "
                 f"step_route {reports[key][0].get('step_route')!r}")
        # The last report window's step (the first holds the warm-up).
        step_ms[key] = 1e3 / reports[key][-1]["steps_per_second"]
        peaks[key] = [results[r].get("peak_gib") for r in sorted(results)]
    if len({len(r) for r in reports.values()}) != 1:
        fail(f"{tag} {name}: report windows at world 2 and 1: "
             f"{ {k: len(r) for k, r in reports.items()} }")

    def distance(got, want):
        return {key: max(abs(a[key] - b[key]) / abs(b[key])
                         for a, b in zip(reports[got], reports[want]))
                for key in ("loss", "grad_norm")}

    rel = distance(2, 1)
    if repeat:
        again = distance("again", 1)
        say(f"[{tag}] [{card}] {name}: world 1 again against world 1, each "
            f"report window: loss {[r['loss'] for r in reports['again']]}"
            f", max relative diff {again['loss']:.2e}; grad_norm max "
            f"relative diff {again['grad_norm']:.2e}; step of the last "
            f"report window {step_ms['again']:.2f} ms")
    say(f"[{tag}] [{card}] {name}: 2 against 1, each report window: "
        + "; ".join(
            f"{key} {[r[key] for r in reports[2]]} / "
            f"{[r[key] for r in reports[1]]}, max relative diff "
            f"{rel[key]:.2e} (rtol {tol:g})"
            for key, tol in (("loss", SPLIT_LOSS_RTOL),
                             ("grad_norm", SPLIT_NORM_RTOL)))
        + f"; step of the last report window {step_ms[2]:.2f} / "
        f"{step_ms[1]:.2f} ms; max_memory_allocated by rank "
        f"{peaks[2]} / {peaks[1]} GiB")
    if rel["loss"] > SPLIT_LOSS_RTOL or rel["grad_norm"] > SPLIT_NORM_RTOL:
        fail(f"{tag} {name}: world 2's losses or grad norms differ from "
             f"world 1's: {rel}")
    return rel, step_ms, peaks


def phase_pipeline_world(workdir, hparams, card):
    """16b: with two cards, pipeline.yaml's trial at `pipeline: 2`, world
    2, against world 1 at phase 7's hparams (world_against_one). With one
    card: not run."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        say(f"[16b] not run: {n} card")
        return None
    return world_against_one(workdir, hparams, "16b", "pipeline",
                             {"mesh": {"data": 1}}, card,
                             LAUNCHED_TRIAL + 20)


def phase_moe_split_world(workdir, hparams, card):
    """16d: with two cards, the MoE trial (moe.yaml's model) at `tensor:
    2` and at `context: 2` with ring attention, each against world 1
    (world_against_one). With one card: not run."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        say(f"[16d] not run: {n} card")
        return None
    moe = {**hparams, **MOE_HPARAMS}
    return {name: world_against_one(workdir, moe, "16d", name, extra, card,
                                    LAUNCHED_TRIAL + 30 + 10 * i)
            for i, (name, extra) in enumerate((
                ("tensor", {"mesh": {"data": 1}}),
                ("context", {"mesh": {"data": 1},
                             "attention_impl": "ring"})))}


# ----------------------------------------------------------------- phase 17

ELASTIC_STEPS = 18      # 17b: shrink at step 6, grow back at step 12
ELASTIC_FIT_STEPS = 5   # 17a: fit after the restore at world 1
# One rank of phase 17, run as `python elastic_worker.py ROOT OUT MODE
# RANK WORLD HPARAMS_JSON [PORT]`. MODE "write" (17a): a gloo world on the
# CPU builds phase 7's state over `fsdp: WORLD` and writes it per rank,
# and the chief the same state in the one-process format. MODE "elastic"
# (17b): an NCCL world, one card a rank, trains ELASTIC_STEPS steps with
# a shrink to half the world at step 6 and a grow back at step 12, then
# two uninterrupted runs resumed from the checkpoints the resizes took.
ELASTIC_WORKER = r"""
import json, os, shutil, sys, time
root, out, mode = sys.argv[1], sys.argv[2], sys.argv[3]
rank, world = int(sys.argv[4]), int(sys.argv[5])
hparams = json.loads(sys.argv[6])
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(root, "examples", "gpt2_cuda"))
import torch
import torch.distributed as tdist
from determined_tpu_torch import core
from determined_tpu_torch.core._checkpoint import CheckpointContext
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.train import Trainer
from determined_tpu_torch.train import state as state_mod
from determined_tpu_torch.train.trial import TrialContext
from model_def import GPT2Trial


def dump(name, obj):
    with open(os.path.join(out, name), "w") as f:
        json.dump(obj, f)


if mode == "write":
    dist = DistributedContext.from_allocation(
        "file://" + os.path.join(out, "store"), world, rank, backend="gloo")
    ctx = core.init(max_length=1, distributed=dist, async_checkpointing=False,
                    checkpoint_dir=os.path.join(out, "sharded"))
    trainer = Trainer(GPT2Trial(TrialContext(
        hparams={**hparams, "mesh": {"data": 1, "fsdp": world}},
        core_context=ctx)), core_context=ctx, device="cpu")
    trainer._build(0)
    sid = ctx.checkpoint.save_state(state_mod.checkpoint_view(trainer.state),
                                    0)
    ck = os.path.join(out, "sharded", sid)
    mine = [f"state/rank{rank}.pt"] + (
        ["state/tree.pt", "shards.json", "metadata.json"] if rank == 0
        else [])
    dump(f"write{rank}.json", {"sid": sid, "bytes": sum(
        os.path.getsize(os.path.join(ck, rel)) for rel in mine)})
    full = state_mod.unshard_state(trainer.state)
    if rank == 0:
        CheckpointContext(os.path.join(out, "one")).save_state(full, 0)
    tdist.barrier()
    ctx.close()
    sys.exit(0)

port = int(sys.argv[7])
# NCCL on the cards; DET_TORCH_BACKEND=gloo runs the same world on the CPU.
backend = os.environ.get("DET_TORCH_BACKEND", "nccl")
device = "cuda" if backend == "nccl" else "cpu"
dist = DistributedContext.from_allocation(
    f"tcp://127.0.0.1:{port}", world, rank, backend=backend, local_rank=rank)
cuda = device == "cuda"
half = world // 2 if world >= 4 else 1
full_width = 4 if world >= 4 else 2


class Trial(GPT2Trial):
    def __init__(self, context, skip=0):
        super().__init__(context)
        self._skip = skip

    def build_training_data(self):
        for b, batch in enumerate(super().build_training_data()):
            if b >= self._skip:
                yield batch


contexts = []


def run(name, max_length, slots, skip=0, resizes=None, resume_from=None):
    # `resizes`: {step: target}, offered when the step's metrics are
    # reported, so the poll after it resizes (the prefetcher's producer
    # runs ahead of the loop: the loader cannot time it).
    d = os.path.join(out, name)
    ctx = core.init(max_length=max_length, distributed=dist,
                    checkpoint_dir=os.path.join(d, "ckpt"))
    contexts.append(ctx)  # closed at the end: close() ends the group
    pending, report = dict(resizes or {}), ctx.train.report_training_metrics

    def report_and_offer(step, metrics):
        report(step, metrics)
        if "loss" in metrics and step in pending:
            ctx.preempt.force_resize(pending.pop(step), deadline=600.0)

    ctx.train.report_training_metrics = report_and_offer
    trial = Trial(TrialContext(hparams={**hparams,
                                        "mesh": {"data": 1, "fsdp": -1}},
                               core_context=ctx), skip=skip)
    trainer = Trainer(trial, core_context=ctx, slots=slots, device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = trainer.fit(report_period=1, preempt_period=1,
                        resume_from=resume_from)
    if cuda:
        torch.cuda.synchronize()
    dump(f"{name}.rank{rank}.json", {
        "step": None if state is None else state.step,
        "parts": trainer.resize_parts,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
        else 0.0})
    if rank == 0:
        dump(f"{name}.json", {"metrics": [
            [r["steps_completed"], r["metrics"]]
            for r in ctx.train.local_training_metrics]})
    del state, trainer
    if cuda:
        torch.cuda.empty_cache()
    tdist.barrier()


def copy(src_run, sid, dst_run):
    if rank == 0:
        shutil.copytree(os.path.join(out, src_run, "ckpt", sid),
                        os.path.join(out, dst_run, "ckpt", sid))
    tdist.barrier()


run("elastic", ELASTIC_STEPS, full_width, resizes={6: half, 12: full_width})
copy("elastic", "trial0-step6", "resumed_half")
run("resumed_half", 12, half, skip=6, resume_from="trial0-step6")
copy("elastic", "trial0-step12", "resumed_full")
run("resumed_full", ELASTIC_STEPS, full_width, skip=12,
    resume_from="trial0-step12")
# The contexts' close destroys the process group, which must return with
# the fits' captured graphs released; every thread's stack, and an exit,
# if it takes two minutes.
import faulthandler
faulthandler.dump_traceback_later(120, exit=True)
t0 = time.monotonic()
for ctx in contexts:
    ctx.close()
faulthandler.cancel_dump_traceback_later()
dump(f"closed.rank{rank}.json", {"seconds": time.monotonic() - t0})
""".replace("ELASTIC_STEPS", str(ELASTIC_STEPS))


def elastic_world(workdir, hparams, mode, world, env=None, timeout=900):
    """Phase 17's worker in `world` processes -> (the run directory, each
    rank's output)."""
    import shutil

    out = os.path.join(workdir, f"elastic_{mode}")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    script = os.path.join(out, "elastic_worker.py")
    with open(script, "w") as f:
        f.write(ELASTIC_WORKER)
    port = str(free_port())
    full_env = dict(os.environ, **(env or {}))
    full_env["PYTHONPATH"] = ROOT + os.pathsep + full_env.get("PYTHONPATH",
                                                              "")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        full_env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, script, ROOT, out, mode, str(r), str(world),
         json.dumps(hparams), port], env=full_env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            say(log[-4000:])
            fail(f"17 {mode}: rank {r} exited {p.returncode}")
    return out, logs


def phase_elastic_restore(workdir, hparams, card, one_restore_ms=None):
    """17a: a gloo world of 4 CPU processes builds phase 7's state (fsdp
    4, the phase's seed) and writes it per rank, and the chief writes the
    same state in the one-process format; this process restores both at
    world 1 on the card, into templates built from the checkpoints with
    no `init_params` call, holds them to each other bitwise, then trains
    ELASTIC_FIT_STEPS steps of `fit` resumed from the per-rank one."""
    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.core._checkpoint import CheckpointContext
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train import state as state_mod
    from determined_tpu_torch.train.trial import TrialContext

    t0 = time.monotonic()
    out, _ = elastic_world(workdir, hparams, "write", 4,
                           env={"CUDA_VISIBLE_DEVICES": ""}, timeout=600)
    write_s = time.monotonic() - t0
    wrote = [json.load(open(os.path.join(out, f"write{r}.json")))
             for r in range(4)]
    sid = wrote[0]["sid"]
    GPT2Trial = gpt2_trial_class()
    calls = [0]

    class Counted(GPT2Trial):
        def init_params(self, rng):
            calls[0] += 1
            return super().init_params(rng)

    trial = Counted(TrialContext(hparams=hparams))
    restored, times = {}, {}
    torch.zeros(1, device="cuda")  # the CUDA context, outside the times
    torch.cuda.synchronize()
    for name in ("sharded", "one"):
        ctx = CheckpointContext(os.path.join(out, name))
        t1 = time.monotonic()
        template = state_mod.empty_train_state(
            ctx.abstract_state(sid), trial.optimizer(), "cuda")
        torch.cuda.synchronize()
        t2 = time.monotonic()
        restored[name] = state_mod.from_checkpoint_view(ctx.restore_state(
            sid, state_mod.checkpoint_view(template), into=True))
        torch.cuda.synchronize()
        t3 = time.monotonic()
        times[name] = {"template_ms": (t2 - t1) * 1e3,
                       "restore_ms": (t3 - t2) * 1e3,
                       "bytes": ctx.last_restore_bytes}
        del template
    got, want = (state_tensors(restored[k]) for k in ("sharded", "one"))
    same = len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    n_bytes = sum(t.numel() * t.element_size() for t in want)
    del restored, got, want
    _free_cuda()
    say(f"[17a] [{card}] a gloo world of 4 CPU processes wrote phase 7's "
        f"state ({n_bytes / 1e9:.2f} GB of tensors) per rank at fsdp 4 in "
        f"{write_s:.1f} s (world start included); bytes written by rank "
        f"{[w['bytes'] for w in wrote]}")
    for name, what in (("sharded", "per-rank checkpoint"),
                       ("one", "one-process checkpoint")):
        t = times[name]
        say(f"[17a] [{card}] world 1 on the card from the {what}: template "
            f"{t['template_ms']:.1f} ms of host time (no init_params), "
            f"restore {t['restore_ms']:.1f} ms, {t['bytes'] / 1e6:.1f} MB "
            f"read, {t['bytes'] / 1e6 / (t['restore_ms'] / 1e3):.1f} MB/s")
    if one_restore_ms is not None:
        say(f"[17a] [{card}] 14c's one-process restore_state of the same "
            f"size of state in this run: {one_restore_ms:.1f} ms")
    say(f"[17a] per-rank restore bitwise equal to the one-process one: "
        f"{same}; init_params calls for the templates: {calls[0]}")
    if not same or calls[0] != 0:
        fail("17a: the per-rank checkpoint did not restore the one-process "
             "state bitwise, or a template called init_params")

    ckpt = os.path.join(workdir, "elastic_fit")
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.copytree(os.path.join(out, "sharded"), ckpt)
    ctx = core.init(max_length=ELASTIC_FIT_STEPS, checkpoint_dir=ckpt)
    trainer = Trainer(GPT2Trial(TrialContext(hparams=hparams,
                                             core_context=ctx)),
                      core_context=ctx)
    flash_counts(reset=True)
    state = trainer.fit(report_period=1, resume_from=sid)
    launches = flash_counts()
    losses = [r["metrics"]["loss"] for r in ctx.train.local_training_metrics
              if "loss" in r["metrics"]]
    ctx.close()
    say(f"[17a] [{card}] fit resumed from the per-rank checkpoint at world "
        f"1: {len(losses)} steps to step {state.step}, losses "
        f"{[round(x, 4) for x in losses]}, flash launches {launches}")
    if state.step != ELASTIC_FIT_STEPS or len(losses) != ELASTIC_FIT_STEPS \
            or not all(math.isfinite(x) for x in losses) \
            or min(launches.values()) == 0:
        fail("17a: fit after the per-rank restore did not train through "
             "the flash kernels")
    shutil.rmtree(out, ignore_errors=True)
    del state, trainer
    _free_cuda()
    return {"launches": launches, "times": times, "wrote": wrote}


def _stretch(rep, lo, hi):
    return {s: m for s, m in rep["metrics"] if "loss" in m and lo < s <= hi}


def phase_elastic_world(workdir, hparams, card, world=None, tag="17b"):
    """17b: with two cards or more, an NCCL world trains phase 7's trial
    at `fsdp: -1` in local mode: four cards shrink 4 -> 2 at step 6 and
    grow back to 4 at step 12, two or three 2 -> 1 -> 2. Each stretch
    after a resize against an uninterrupted run of its width resumed from
    the checkpoint the resize took: bitwise, or within 12d's limits. Every
    width's fit replays its step (each first flush after a build reads
    `step_captured` 1.0), and the worker's close, which destroys the
    process group, returns. With one card: not run. 22c is the same at
    `world` 2 (2 -> 1 -> 2), held bitwise."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        say(f"[{tag}] not run: {n} card")
        return None
    world = min(n, 4) if world is None else world
    t0 = time.monotonic()
    out, _ = elastic_world(workdir, hparams, "elastic", world)
    load = lambda name: json.load(open(os.path.join(out, name)))  # noqa
    rep = load("elastic.json")
    ranks = [load(f"elastic.rank{r}.json") for r in range(world)]
    closed = [load(f"closed.rank{r}.json")["seconds"] for r in range(world)]
    rows = [(s, m) for s, m in rep["metrics"] if "resize_downtime_ms" in m]
    if [s for s, _ in rows] != [6, 12] or ranks[0]["step"] != ELASTIC_STEPS:
        fail(f"{tag}: resizes at {[s for s, _ in rows]}, final step "
             f"{ranks[0]['step']}")
    routes = {name: [(m.get("step_captured"), m.get("step_route"))
                     for _, m in load(f"{name}.json")["metrics"]
                     if "step_route" in m]
              for name in ("elastic", "resumed_half", "resumed_full")}
    say(f"[{tag}] [{card}] world {world}: each fit's first flushes after a "
        f"build: {routes}; the process group destroyed in "
        f"{[round(c, 2) for c in closed]} s by rank")
    if [len(r) for r in routes.values()] != [3, 1, 1] or any(
            c != 1.0 for r in routes.values() for c, _ in r):
        fail(f"{tag}: a width's fit did not replay its step: {routes}")
    for i, (step, row) in enumerate(rows):
        say(f"[{tag}] [{card}] resize {int(row['resize_from_slots'])} -> "
            f"{int(row['resize_target_slots'])} at step {step}: "
            f"resize_downtime_ms {row['resize_downtime_ms']:.1f}")
        for r, got in enumerate(ranks):
            parts = [p for p in got["parts"]]
            if i >= len(parts):
                continue
            p = parts[i]
            say(f"[{tag}]   rank {r}: " + ", ".join(
                f"{k[:-3]} {v:.1f} ms" for k, v in p.items()
                if k.endswith("_ms"))
                + f"; read {p.get('restore_bytes', 0) / 1e6:.1f} MB")
    say(f"[{tag}] [{card}] peak memory by rank over the elastic fit "
        f"{[round(g['peak_gib'], 3) for g in ranks]} GiB")
    worst = {}
    for ref, lo, hi in (("resumed_half", 6, 12),
                        ("resumed_full", 12, ELASTIC_STEPS)):
        a, b = _stretch(rep, lo, hi), _stretch(load(f"{ref}.json"), lo, hi)
        if sorted(a) != sorted(b) or len(a) != hi - lo:
            fail(f"{tag}: steps {sorted(a)} against {ref}'s {sorted(b)}")
        bitwise = all(a[s][k] == b[s][k] for s in a
                      for k in ("loss", "grad_norm"))
        rel = {k: max(abs(a[s][k] - b[s][k]) / abs(b[s][k]) for s in a)
               for k in ("loss", "grad_norm")}
        worst[ref] = rel
        say(f"[{tag}] [{card}] steps {lo + 1}-{hi} against {ref} (resumed "
            f"from trial0-step{lo}): bitwise {bitwise}; max relative diff "
            f"loss {rel['loss']:.2e}, grad norm {rel['grad_norm']:.2e}")
        if not bitwise and (tag == "22c" or rel["loss"] > SPLIT_LOSS_RTOL
                            or rel["grad_norm"] > SPLIT_NORM_RTOL):
            fail(f"{tag}: the stretch after a resize differs from {ref}")
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    say(f"[{tag}] [{card}] {time.monotonic() - t0:.1f} s")
    return {"rows": rows, "ranks": ranks, "rel": worst, "closed": closed,
            "routes": routes}


# ----------------------------------------------------------------- phase 18

# 18a: the conv models' layers split over tensor, as t pieces in one
# process. The UNet is finetune_asha.yaml's model (base, bf16 activations,
# fp32 params) at its global batch; ResNet-50's head and loss at
# bench_resnet.py's batch; MNIST's fc pair at config.yaml's width and
# batch. The limits are 16c's: each split layer against the unsplit one.
CONV_SPLITS = (2, 4)
UNET_BATCH = 64
# float64 holds the split to the same function up to rounding; fp32 and
# bf16 are 16c's limits. An fp32 gradient that is a long reduction (a
# conv's kernel over B x H x W) rounds differently in another algorithm
# by about 1e-5 of its largest element, so past the limit the split is
# held to float64 instead: no farther from it than twice the whole is
# (13d's rule).
CONV_SPLIT_TOL = {"float64": 1e-10, "float32": MOE_TENSOR_FP32_TOL,
                  "bfloat16": MOE_TENSOR_BF16_TOL}


def conv_split_layers(dtype, seed, device="cuda", rows=None):
    """The layers of 18a in `dtype` (the UNet's activations; the head and
    the fc pair compute in fp32 in their models whatever the activations'
    dtype): {name: (params, inputs, whole, split, piece)}. `whole(P, I)`
    is the model's own layer, unsplit; `split(P, I, t, cat, once)`
    computes it from the model's own parts (`diffusion._res_part1`, ...,
    the functions each tensor rank runs), each on its rank's pieces of the
    params as the state cuts them (`sharding.tensor_piece`), combined as
    the collectives combine them: a part's output channels by `cat`, the
    gather; shares summed, Megatron's g, with a bias added `once`; a whole
    input shared by the parts, Megatron's f, whose gradient autograd sums
    as f's all-reduce does. `piece(P, I, t)` is rank 0's part alone, the
    gathered or summed inputs it reads given whole. In float64 the params
    are float64 too (the models' fp32 params would round every gradient to
    fp32). `device`: the card; the CPU in the tests, which cut every
    layer's batch to `rows`."""
    import numpy as np
    import torch

    from determined_tpu_torch.models import _conv, diffusion, mnist, resnet
    from determined_tpu_torch.parallel import sharding

    gen = torch.Generator(device=device).manual_seed(seed)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    cfg = diffusion.Config(dtype=dtype)
    unet = diffusion.init(gen, cfg)
    unet_axes = diffusion.param_logical_axes(cfg)

    def noisy(tree):
        # init's zero biases and unit norms hide a bias added twice.
        return {k: noisy(v) if isinstance(v, dict) else
                (v + 0.1 * torch.randn(v.shape, generator=gen,
                                       device=device)).to(pdt)
                .requires_grad_()
                for k, v in tree.items()}

    def image(b, c, h):
        x = torch.randn((b, h, h, c), generator=gen, device=device)
        return _conv.nchw(x, dtype).detach().requires_grad_()

    def piece_of(P, axes, r, t):
        # Rank r's pieces of a tree of params, as the state cuts them.
        return {k: piece_of(v, axes[k], r, t) if isinstance(v, dict) else
                sharding.tensor_piece(v, axes[k], r, t)
                for k, v in P.items()}

    def layer(P, axes, inputs, whole, part):
        # `part(p, I, t, pieces)`: rank-by-rank parts, combined.
        def split(P, I, t, cat, once):
            return part(I, [piece_of(P, axes, r, t) for r in range(t)],
                        P, cat, once)

        def piece(P, I, t):
            return part(I, [piece_of(P, axes, 0, t)], P, None, None)

        return P, inputs, whole, split, piece

    def split_conv(name, P, axes, x, stride=1, up=False):
        def whole(P, I):
            x = diffusion._upsample(I["x"]) if up else I["x"]
            return diffusion._conv2d(x, P, stride)

        def part(I, ps, P, cat, once):
            x = diffusion._upsample(I["x"]) if up else I["x"]
            parts = [diffusion._conv_part(x, p, stride=stride) for p in ps]
            return cat(parts) if cat else parts[0]

        layers[name] = layer(P, axes, {"x": x}, whole, part)

    B = rows or UNET_BATCH
    layers = {}
    # conv_in, the level-0 down conv, the up conv at the lowest level.
    split_conv("unet conv_in", noisy(unet["conv_in"]), unet_axes["conv_in"],
               image(B, 3, 32))
    split_conv("unet down", noisy(unet["down"]["0"]["down"]),
               unet_axes["down"]["0"]["down"], image(B, 64, 32), stride=2)
    split_conv("unet up", noisy(unet["up"]["0"]["up"]),
               unet_axes["up"]["0"]["up"], image(B, 256, 8), up=True)

    # The level-1 resblock (64 -> 128 channels at 16x16, a skip conv).
    def res_whole(P, I):
        return diffusion._resblock(I["x"], I["temb"], P, cfg)

    def res_part(I, ps, P, cat, once):
        x, temb = I["x"], I["temb"]
        h = [diffusion._res_part1(x, temb, p, cfg) for p in ps]
        h = cat(h) if cat else I["h"]
        out = [diffusion._res_part2(h, x, p, cfg) for p in ps]
        return cat(out) if cat else out[0]

    temb = torch.randn((B, cfg.time_dim), generator=gen,
                       device=device).to(pdt).requires_grad_()
    layers["unet resblock"] = layer(
        noisy(unet["down"]["1"]["res"]), unet_axes["down"]["1"]["res"],
        {"x": image(B, 64, 16), "temb": temb,
         "h": image(B, 128, 16).detach()}, res_whole, res_part)

    # The mid attention over c = 256 channels at 8x8.
    def attn_whole(P, I):
        return diffusion._self_attention(I["x"], P, cfg)

    def attn_part(I, ps, P, cat, once):
        parts = [diffusion._attn_part1(I["x"], p, cfg) for p in ps]
        logits = sum(lg for lg, _ in parts) if cat else I["logits"]
        o = [diffusion._attn_part2(logits, v, p)
             for p, (_, v) in zip(ps, parts)]
        return diffusion._attn_out(I["x"], sum(o), P) if cat else o[0]

    P = noisy(unet["mid"]["attn"])
    x = image(B, 256, 8)
    with torch.no_grad():
        logits = diffusion._attn_part1(x, P, cfg)[0]
    layers["unet attention"] = layer(
        P, unet_axes["mid"]["attn"], {"x": x, "logits": logits},
        attn_whole, attn_part)

    # ResNet-50's head and loss: pooled fp32 features [256, 2048] -> 1000.
    rng = np.random.default_rng(seed)
    rb, width, classes = rows or RESNET50_BATCH, 2048, 1000
    head = {"head": {
        "kernel": torch.from_numpy(0.02 * rng.normal(size=(
            width, classes))).to(device, pdt).requires_grad_(),
        "bias": torch.from_numpy(0.1 * rng.normal(size=classes)).to(
            device, pdt).requires_grad_()}}
    feats = torch.randn((rb, width), generator=gen, device=device) \
        .to(pdt).requires_grad_()
    labels = torch.from_numpy(rng.integers(0, classes, rb)).to(device)

    def head_whole(P, I):
        return resnet._nll(resnet._head_part(I["x"], P)
                           + _conv.wide(P["head"]["bias"]), labels)[0]

    def head_part(I, ps, P, cat, once):
        parts = [resnet._head_part(I["x"], p) for p in ps]
        logits = cat(parts) if cat else I["logits"]
        return resnet._nll(logits + _conv.wide(P["head"]["bias"]),
                           labels)[0]

    with torch.no_grad():
        logits = resnet._head_part(feats, head)
    layers["resnet50 head+loss"] = layer(
        head, {"head": resnet.param_logical_axes()["head"]},
        {"x": feats, "logits": logits}, head_whole, head_part)

    # MNIST's fc pair at config.yaml's hidden 128 and batch 64.
    mcfg = mnist.Config(hidden=128)
    fc = noisy({k: mnist.init(gen, mcfg)[k] for k in ("fc1", "fc2")})
    flat = torch.randn((rows or 64, 7 * 7 * mcfg.c2), generator=gen,
                       device=device).to(pdt).requires_grad_()

    def fc_whole(P, I):
        return mnist._fc_part(I["x"], P) + P["fc2"]["bias"]

    def fc_part(I, ps, P, cat, once):
        parts = [mnist._fc_part(I["x"], p) for p in ps]
        return once(sum(parts), P["fc2"]["bias"], len(ps)) if cat \
            else parts[0]

    layers["mnist fc pair"] = layer(
        fc, mnist.param_logical_axes(mcfg), {"x": flat}, fc_whole, fc_part)
    return layers


def _leaves(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{j}": t for j, t in _leaves(v).items()})
        else:
            out[k] = v
    return out


def _fresh(tree):
    """A copy of a tree of leaves, each a new leaf that takes gradients."""
    return {k: _fresh(v) if isinstance(v, dict) else
            v.detach().clone().requires_grad_(v.requires_grad)
            for k, v in tree.items()}


def layer_run(layer, fn):
    """(output, {leaf: gradient}) of `fn(P, I)` on fresh copies of one
    layer's params and inputs, under a cotangent drawn from a seed."""
    import torch

    params, inputs = layer[:2]
    P, I = _fresh(params), _fresh(inputs)
    out = fn(P, I)
    g = torch.randn(out.shape, generator=torch.Generator(
        device=out.device).manual_seed(SEED + 81), device=out.device).to(
        out.dtype)
    leaves = {**_leaves(P), **{k: v for k, v in I.items()
                               if v.requires_grad}}
    grads = torch.autograd.grad((out * g).sum(), list(leaves.values()),
                                allow_unused=True)
    return out.detach(), {k: v for k, v in zip(leaves, grads)
                          if v is not None}


def run_errors(got, want):
    """{"output" or a leaf: max |got - want| / max |want|} of two
    layer_runs, compared in the wider of their dtypes and fp32."""
    import torch

    def wide(t):
        return t.to(torch.promote_types(t.dtype, torch.float32))

    pairs = {"output": (got[0], want[0]), **{
        k: (got[1][k], want[1][k]) for k in want[1]}}
    return {k: _rel(wide(a).to(wide(b).dtype), wide(b))
            for k, (a, b) in pairs.items()}


def split_errors(layer, t, cat, once):
    """run_errors of one layer split in t pieces against the whole."""
    whole, split = layer[2], layer[3]
    return run_errors(
        layer_run(layer, lambda P, I: split(P, I, t, cat, once)),
        layer_run(layer, whole))


def phase_conv_split(card):
    """18a: each conv model's split layers as t pieces for t = 2 and 4, in
    float64, fp32 and bf16, against the unsplit layer: outputs and every
    gradient within CONV_SPLIT_TOL of the largest element (every reading
    printed before a breach fails the phase); a gather with a summing
    backward and a bias added t times must be refused; each piece's
    device time against the whole layer's (forward, no limit)."""
    import torch

    class SummingCat(torch.autograd.Function):
        # The fault: a gather whose backward sums every rank's (equal)
        # gradient, a reduce-scatter: t times the rank's slice.
        @staticmethod
        def forward(ctx, *pieces):
            ctx.n = [p.shape[1] for p in pieces]
            return torch.cat(pieces, dim=1)

        @staticmethod
        def backward(ctx, grad):
            return tuple(len(ctx.n) * g for g in grad.split(ctx.n, dim=1))

    def cat(pieces):
        return torch.cat(pieces, dim=1)

    def once(x, bias, t):
        return x + bias

    def every(x, bias, t):
        return x + t * bias

    t0 = time.monotonic()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {"errors": {}, "ms": {}}
    breaches = []
    truth = {}  # the whole layers' float64 runs
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        tol = CONV_SPLIT_TOL[name]
        layers = conv_split_layers(dtype, SEED + 80)
        for layer_name, layer in layers.items():
            whole = layer_run(layer, layer[2])
            if dtype == torch.float64:
                truth[layer_name] = whole
            for t in CONV_SPLITS:
                split = layer_run(layer, lambda P, I: layer[3](
                    P, I, t, cat, once))
                err = run_errors(split, whole)
                over = {k: v for k, v in err.items() if v > tol}
                if dtype == torch.float32 and over:
                    # Beyond 1e-5 only as far as the whole's own fp32
                    # rounding goes: the split no farther from float64.
                    far = (run_errors(split, truth[layer_name]),
                           run_errors(whole, truth[layer_name]))
                    say(f"[18a] [{card}] {layer_name}, fp32, tensor {t}: "
                        + "; ".join(f"{k} {v:.3e}: from float64 split "
                                    f"{far[0][k]:.3e}, whole {far[1][k]:.3e}"
                                    for k, v in over.items()))
                    over = {k: v for k, v in over.items()
                            if far[0][k] > 2 * far[1][k]}
                worst = max(err, key=err.get)
                out["errors"][(layer_name, name, t)] = err[worst]
                say(f"[18a] [{card}] {layer_name}, {name}, tensor {t} "
                    f"pieces against the whole: output {err['output']:.3e}, "
                    f"worst of {len(err)} ({worst}) {err[worst]:.3e} "
                    f"(limit {tol:g}); beyond it: {over or 'none'}")
                breaches += [(layer_name, name, t, k, v)
                             for k, v in over.items()]
        # The planted faults, in fp32 at tensor 2.
        if dtype == torch.float32:
            faults = (("unet resblock", lambda ps: SummingCat.apply(*ps),
                       once, "a gather whose backward sums"),
                      ("mnist fc pair", cat, every, "fc2's bias added t "
                       "times"))
            for layer_name, fcat, fonce, what in faults:
                err = split_errors(layers[layer_name], 2, fcat, fonce)
                worst = max(err, key=err.get)
                refused = err[worst] > tol
                say(f"[18a] [{card}] planted fault ({what}) in "
                    f"{layer_name} at tensor 2: worst {worst} "
                    f"{err[worst]:.3e}, refused: {refused}")
                if not refused:
                    breaches.append((layer_name, "fault", 2, what, 0.0))
        # Device times in the activations' dtype of the models (the
        # UNet's bf16; the head and the fc pair compute in fp32 anyway).
        if dtype == torch.bfloat16:
            with torch.no_grad():
                for layer_name, (P, I, whole, _, piece) in layers.items():
                    row = {"whole": time_cold(whole, (P, I), flush)}
                    for t in CONV_SPLITS:
                        row[t] = time_cold(piece, (P, I, t), flush)
                    out["ms"][layer_name] = row
                    say(f"[18a] [{card}] {layer_name} forward device ms: "
                        f"whole {row['whole']:.4f}; one piece at tensor 2 "
                        f"{row[2]:.4f} ({row[2] / row['whole']:.2f}x), at "
                        f"tensor 4 {row[4]:.4f} "
                        f"({row[4] / row['whole']:.2f}x)")
        del layers
    say(f"[18a] [{card}] {time.monotonic() - t0:.1f} s")
    if breaches:
        fail(f"18a: split layers beyond their limits, or a planted fault "
             f"not refused: {breaches}")
    del flush
    _free_cuda()
    return out


def phase_conv_split_world(workdir, card):
    """18b: with two cards, the diffusion example's trial at `tensor: 2`
    and at `context: 2`, and 13c's CIFAR ResNet-18 trial at `tensor: 2`,
    each at world 2 against world 1 (world_against_one); the CIFAR run
    (bf16 activations, lr 0.1) repeats world 1, so its distance is read
    against world 1's own spread, and runs again in fp32, so it is read
    against what bf16 rounding adds. With one card: not run."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        say(f"[18b] not run: {n} card")
        return None
    diff = {**yaml_hparams(os.path.join(
        ROOT, "examples/diffusion_cuda/finetune_asha.yaml")),
        **DIFFUSION_POINT}
    unet = "examples/diffusion_cuda/model_def.py:DiffusionTrial"
    runs = (("diffusion", "tensor", diff, unet, False),
            ("diffusion", "context", diff, unet, False),
            ("cifar", "tensor", {"global_batch_size": CIFAR_BATCH},
             "chip_smoke.py:cifar_trial_class()", True),
            ("cifar-fp32", "tensor", {"global_batch_size": CIFAR_BATCH,
                                      "dtype": "float32"},
             "chip_smoke.py:cifar_trial_class()", False))
    return {f"{model} {axis}": world_against_one(
        workdir, hp, f"18b-{model}", axis, {"mesh": {"data": 1}}, card,
        LAUNCHED_TRIAL + 50 + 10 * i, entry=entry, repeat=repeat)
        for i, (model, axis, hp, entry, repeat) in enumerate(runs)}


# ------------------------------------------------------------------ phase 19


# One process of 19b's and 19c's runs, as `python p19_worker.py ROOT MODE
# ARGS_JSON`: "replica_cold" (a corrupt artifact refused without nvcc, then
# rebuilt, then the replica built and captured), "warm" (the replica from
# the node's AOT directory, then the flash library from the worker's
# artifacts and the phase 3 and 4 cases on both fetched libraries). Its
# kernel directory (DET_KERNEL_DIR) starts empty.
P19_WORKER = r'''
import json, os, sys, time
ROOT, MODE, ARGS = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, ROOT)
import numpy as np
import torch
import chip_smoke
from determined_tpu_torch.compile.runtime import FarmClient
from determined_tpu_torch.ops import _build
from determined_tpu_torch.serve.task import build_replica

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {}


def replica():
    """Build and capture 5's replica; a prefill and decode steps -> the
    paged launches a decode step holds."""
    t0 = time.monotonic()
    engine, _ = build_replica(ARGS["config"])
    engine.compile()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    prompt = np.random.default_rng(0).integers(0, 50257, 40).astype(np.int32)
    engine.prefill_logits(0, prompt)
    n, launches0 = 4, engine.attention_launches
    pos = np.zeros(engine.slots, np.int32)
    tok = np.zeros(engine.slots, np.int32)
    for i in range(n):
        pos[0] = len(prompt) + i
        engine.decode_logits(tok, pos)
    torch.cuda.synchronize()
    return {"build_capture_s": secs, "stats": dict(engine.compile_stats),
            "launches_per_step": (engine.attention_launches - launches0) / n,
            "n_layer": engine.cfg.n_layer}


if MODE == "replica_cold":
    try:
        build_replica(ARGS["config"])[0].compile()
        out["refused"] = None
    except RuntimeError as e:
        out["refused"] = str(e).splitlines()[0]
    os.environ["CUDA_HOME"] = ARGS["cuda_home"]
    os.environ["PATH"] = ARGS["path"]
    out["replica"] = replica()
else:
    out["replica"] = replica()
    _build.load("flash_attention", farm=FarmClient(None, ARGS["signature"]))
    chip_smoke.phase_kernel_check(chip_smoke.PAGED_CASES[1:2])
    chip_smoke.phase_flash_check(chip_smoke.FLASH_CASES[:1])
out["nvcc"] = _build.nvcc_built()
out["sources"] = dict(_build.sources)
print("RESULT " + json.dumps(out), flush=True)
'''


class FarmMaster(FakeMaster):
    """7c's fake master with the compile farm's endpoints: the model def,
    the artifact store by signature, the compile jobs by state and
    fingerprint, and links."""

    def __init__(self, model_def_b64, length=0):
        super().__init__(length)
        self.model_def = model_def_b64
        self.store = {}  # signature -> {name: bytes}
        self.done = {}   # signature -> fingerprint

    def answer(self, method, path, query, body):
        import base64

        out = super().answer(method, path, query, body)
        parts = path.split("/")
        if path.endswith("/model_def"):
            return {"b64_tgz": self.model_def}
        if path == "/api/v1/compile_jobs":
            return {"jobs": [{"signature": s, "fingerprint": f, "state": "DONE"}
                             for s, f in self.done.items()
                             if f == query.get("fingerprint")]}
        if path.startswith("/api/v1/compile_cache/"):
            files = self.store.setdefault(parts[4], {})
            if method == "POST":
                for n, b64 in body["files"].items():
                    files[n] = base64.b64decode(b64)
                return {}
            return {"files": [{"name": n, "b64": base64.b64encode(b).decode()}
                              for n, b in files.items()
                              if query.get("name") in (None, n)]}
        if path.startswith("/api/v1/compile_jobs/"):
            if path.endswith("/link"):
                self.store[parts[4]] = dict(self.store[body["from"]])
                self.done[parts[4]] = body["fingerprint"]
            elif body.get("state") == "DONE":
                self.done[parts[4]] = body["fingerprint"]
        return out


def tar_context(path):
    """The model-def directory as the CLI uploads it: base64 tar.gz."""
    import base64
    import io
    import tarfile

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name in sorted(os.listdir(path)):
            tar.add(os.path.join(path, name), arcname=name)
    return base64.b64encode(buf.getvalue()).decode()


def no_nvcc(root):
    """A CUDA_HOME whose nvcc exits 1: nvcc unreachable."""
    bindir = os.path.join(root, "bin")
    os.makedirs(bindir, exist_ok=True)
    nvcc = os.path.join(bindir, "nvcc")
    with open(nvcc, "w") as f:
        f.write("#!/bin/sh\necho 'nvcc is unreachable here' >&2\nexit 1\n")
    os.chmod(nvcc, 0o755)
    return root


def prewarm(aot_dir, signature, files):
    """What the agent does before a container starts: the signature's aot-
    artifacts written into the node's AOT directory."""
    d = os.path.join(aot_dir, signature)
    os.makedirs(d, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)


def run_p19(workdir, mode, args, env):
    script = os.path.join(workdir, "p19_worker.py")
    with open(script, "w") as f:
        f.write(P19_WORKER)
    proc = subprocess.run([sys.executable, script, ROOT, mode,
                           json.dumps(args)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    with open(os.path.join(workdir, f"p19_{mode}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    lines = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        say((proc.stdout + proc.stderr)[-3000:])
        fail(f"19 {mode}: the process exited {proc.returncode}")
    for line in proc.stdout.splitlines():
        if line.startswith("[kernel]") or line.startswith("[flash]"):
            say(f"[19] {mode}: {line}")
    return json.loads(lines[-1][len("RESULT "):])


def first_flush(master):
    return next(b["metrics"] for b in master.posted("/metrics")
                if b["group"] == "training" and "compile_ms" in b["metrics"])


def compile_spans(master):
    return [s for b in master.posted("/spans") for s in b["spans"]
            if s["name"] == "harness.compile"]


def phase_farm(workdir, hparams, ckpt, card, cold):
    """19: the compile farm and warm start, each process with its own empty
    kernel directory under build/smoke/p19 (never phase 2's build/kernels).
    19a the worker builds both libraries and a second signature of the
    same fingerprint links; 19b 8c's launched trial warm (the worker's
    artifacts prewarmed, nvcc unreachable) against 8c's cold start
    (`cold`, phase_launched_trial's result): bitwise losses,
    `build_seconds` 0.0, `compile_cache_hit` 1, the flash launches of
    phase 7's formula; 19c 5's replica cold (a corrupt artifact refused
    without nvcc, then rebuilt; beside the worker's build) and warm, and
    the phase 3 and 4 cases on the fetched libraries."""
    import hashlib
    import shutil

    from determined_tpu_torch.compile import config_signature, step_fingerprint
    from determined_tpu_torch.ops import _build
    from determined_tpu_torch.serve.task import serving_signature

    t_phase = time.monotonic()
    root = os.path.join(workdir, "p19")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    fake = no_nvcc(os.path.join(root, "no_nvcc"))
    real_path = os.environ.get("PATH", "")
    blocked = {"CUDA_HOME": fake,
               "PATH": os.path.join(fake, "bin") + os.pathsep + real_path}

    def env_for(tag, **extra):
        env = dict(os.environ, PYTHONPATH=ROOT,
                   DET_KERNEL_DIR=os.path.join(root, tag, "kernels"))
        env.update(extra)
        return env

    model_def = tar_context(os.path.join(ROOT, "examples", "gpt2_cuda"))
    md_hash = hashlib.sha256(model_def.encode()).hexdigest()
    master = FarmMaster(model_def)
    hps = (hparams, {**hparams, "learning_rate": 1e-4})
    sigs = [config_signature(hp, "python3 model_def.py", md_hash, 1)
            for hp in hps]

    def worker(i):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "determined_tpu_torch.compile"],
            env=env_for(f"worker{i}", DET_MASTER=master.url,
                        DET_SESSION_TOKEN="smoke",
                        DET_COMPILE_SIGNATURE=sigs[i],
                        DET_COMPILE_HPARAMS=json.dumps(hps[i]),
                        DET_COMPILE_SLOTS="1", DET_EXPERIMENT_ID="1",
                        DET_EXPERIMENT_CONFIG="{}"),
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            say((proc.stdout + proc.stderr)[-3000:])
            fail(f"19a: the compile worker exited {proc.returncode}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        out["process_s"] = time.monotonic() - t0
        return out

    aot = os.path.join(root, "aot")
    serving = {"model": "gpt2",
               "model_config": {"model_size": "small", "dtype": "bfloat16"},
               "checkpoint": ckpt, "max_batch_size": 8, "max_seq_len": 1024,
               "kv_block_size": 16, "prefix_cache": True, "seed": SEED}
    serve_sig = serving_signature(serving)
    paged = _build.artifact_name("paged_attention")
    storage = os.path.join(root, "warm", "checkpoints")
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            # 19a's build and 19c's cold replica (a planted corrupt
            # artifact, then nvcc) side by side: both are nvcc's work.
            built = pool.submit(worker, 0)
            prewarm(aot, serve_sig, {paged: b"\x7fELF corrupt"})
            replica_cold = run_p19(root, "replica_cold", {
                "config": {"serving": serving},
                "cuda_home": os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                "path": real_path}, env_for("replica_cold",
                                            DET_COMPILE_AOT_DIR=aot,
                                            **blocked))
            built = built.result()
            artifacts = master.store.get(sigs[0], {})
            # 19b: the warm trial from the worker's artifacts, prewarmed
            # as the agent does; the link beside it.
            prewarm(aot, sigs[0], artifacts)
            linked = pool.submit(worker, 1)
            t0 = time.monotonic()
            results, tmaster, rc, log = launch_trial(
                workdir, hparams, storage, 1, "[0]",
                trial_id=LAUNCHED_TRIAL + 60, env=env_for(
                    "warm", DET_COMPILE_SIGNATURE=sigs[0],
                    DET_COMPILE_AOT_DIR=aot, **blocked))
            wall = time.monotonic() - t0
            linked = linked.result()
    finally:
        master.close()
    with open(os.path.join(root, "trial_warm.log"), "w") as f:
        f.write(log)

    fingerprint = step_fingerprint()[0]
    names = {_build.artifact_name(n) for n in _build.SOURCES}
    say(f"[19a] [{card}] python -m determined_tpu_torch.compile: built "
        f"{built.get('build_seconds')} s (nvcc, in parallel; compile_ms "
        f"{built.get('compile_ms')}), uploaded {built.get('artifacts')} "
        f"artifacts ({built.get('bytes')} bytes), process "
        f"{built['process_s']:.1f} s; a second signature "
        f"{'linked from the first' if linked.get('linked_from') == sigs[0] else 'did not link'}"
        f" in {linked['process_s']:.1f} s; requests "
        f"{[(m, p.rsplit('/', 1)[-1][:12]) for m, p, q, b in master.requests]}")
    if set(built.get("build_seconds", {})) != set(_build.SOURCES) or \
            built.get("fingerprint") != fingerprint or \
            set(artifacts) != names or \
            master.done.get(sigs[0]) != fingerprint or \
            linked.get("linked_from") != sigs[0] or "build_seconds" in linked \
            or master.store.get(sigs[1]) != artifacts:
        fail(f"19a: the worker did not build, upload and link as expected: "
             f"{built} {linked}")

    if rc != 0 or list(results) != [0]:
        say(log[-3000:])
        fail(f"19b: the warm trial exited {rc}")
    warm = {"result": results[0], "flush": first_flush(tmaster),
            "spans": compile_spans(tmaster), "wall_s": wall,
            "losses": [b["metrics"]["loss"] for b in tmaster.posted("/metrics")
                       if b["group"] == "training" and "loss" in b["metrics"]]}
    want = fit_launches(1, 1, 12)
    for tag, r in (("cold (8c)", cold), ("warm", warm)):
        sp = r["spans"][0] if r["spans"] else {"attrs": {}}
        say(f"[19b] [{card}] {tag} trial: harness.compile "
            f"{r['flush']['compile_ms']:.1f} ms (train_step's first call), "
            f"compile_cache_hit {r['flush']['compile_cache_hit']}, "
            f"build_seconds {r['result']['build_seconds']}, sources "
            f"{r['result']['kernel_sources']}, span attrs {sp['attrs']}, "
            f"flash launches {r['result']['launches']} (expected {want}), "
            f"losses {[round(x, 4) for x in r['losses']]}, process "
            f"{r['wall_s']:.1f} s")
    if warm["result"]["build_seconds"] != {"flash_attention": 0.0} or \
            warm["result"]["kernel_sources"] != {"flash_attention": "farm"} \
            or warm["flush"]["compile_cache_hit"] != 1.0 or \
            warm["result"]["launches"] != want or \
            warm["result"]["reference_calls"] or \
            warm["spans"][0]["attrs"].get("signature") != sigs[0]:
        fail("19b: the warm trial did not run on the fetched library as "
             "expected")
    bitwise = warm["losses"] == cold["losses"]
    say(f"[19b] warm losses bitwise 8c's cold run's: {bitwise}")
    if not bitwise or len(warm["losses"]) != LAUNCHED_STEPS // 5:
        fail("19b: the warm trial's losses differ from the cold run's")

    # 19c: the warm replica from what the cold one saved back, and the
    # phase 3 and 4 cases on the fetched libraries.
    with open(os.path.join(aot, serve_sig, paged), "rb") as f:
        saved_back = f.read()
    replica_warm = run_p19(root, "warm", {
        "config": {"serving": serving}, "signature": sigs[0]},
        env_for("warm_replica", DET_COMPILE_AOT_DIR=aot, **blocked))
    for tag, r in (("cold", replica_cold), ("warm", replica_warm)):
        rep = r["replica"]
        say(f"[19c] [{card}] {tag} replica: built and captured in "
            f"{rep['build_capture_s']:.3f} s ({rep['stats']}); paged "
            f"launches a decode step {rep['launches_per_step']} "
            f"({rep['n_layer']} layers); nvcc {r['nvcc']}, sources "
            f"{r['sources']}")
    say(f"[19c] planted: the corrupt artifact without nvcc raised "
        f"{replica_cold['refused']!r}; with nvcc it was rebuilt "
        f"({replica_cold['replica']['stats'].get('kernel_source')}) and "
        f"saved back ({len(saved_back)} bytes)")
    rc_, rw = replica_cold["replica"], replica_warm["replica"]
    if not replica_cold["refused"] or "cannot be rebuilt" not in \
            replica_cold["refused"] or rc_["stats"].get("kernel_source") \
            != "nvcc" or len(saved_back) <= 64 or \
            rw["stats"].get("kernel_source") != "farm" or \
            rw["stats"].get("kernel_build_s") != 0.0 or replica_warm["nvcc"] \
            or replica_warm["sources"] != {"paged_attention": "farm",
                                           "flash_attention": "farm"} or \
            rw["launches_per_step"] != rw["n_layer"] or \
            rc_["launches_per_step"] != rc_["n_layer"]:
        fail("19c: the replica did not resolve its library as expected")
    say(f"[19] [{card}] harness.compile cold {cold['flush']['compile_ms']:.1f}"
        f" ms against warm {warm['flush']['compile_ms']:.1f} ms; replica "
        f"build + capture cold {rc_['build_capture_s']:.3f} s against warm "
        f"{rw['build_capture_s']:.3f} s; phase 19 took "
        f"{time.monotonic() - t_phase:.1f} s")
    return {"cold_ms": cold["flush"]["compile_ms"],
            "warm_ms": warm["flush"]["compile_ms"],
            "launches_warm": warm["result"]["launches"],
            "paged_per_step_warm": rw["launches_per_step"],
            "worker_build_s": built["build_seconds"],
            "replica_s": {"cold": rc_["build_capture_s"],
                          "warm": rw["build_capture_s"]}}


# ----------------------------------------------------------------- phase 20


def capture_collectives_run(group, x, leaf):
    """20a's function: the port's collectives over `group` (a world-1 NCCL
    process group), forward and backward, on input `x` and the DTensor
    `leaf` (over a mesh of that group)."""
    import torch

    from determined_tpu_torch.parallel import collectives, sharding
    from determined_tpu_torch.train.step import global_mean

    reduced = collectives.all_reduce(x, [group])
    y = x.detach().clone().requires_grad_(True)
    gathered = collectives.gather_from(y, group, dim=1)
    summed = collectives.sum_over(gathered * 2.0, [group])
    full = sharding.gather_for_use(leaf)
    early = sharding.gather_for_use(leaf, async_op=True)
    z = (summed[:, :full.shape[0]] @ full).square().mean() + \
        (x[:, :early.shape[0]] @ early).mean()
    dy, dleaf = torch.autograd.grad(z, [y, leaf])
    means = global_mean([z, summed.mean()])
    return [reduced, gathered.detach(), summed.detach(), dy,
            sharding.local_value(dleaf), *means]


def phase_capture_collectives(card):
    """20a: a world-1 NCCL process group in this process (one card carries
    one NCCL rank: tools/two_ranks_one_card.py): `collectives.all_reduce`,
    `gather_from` and `sum_over` (forward and backward), `gather_for_use`
    of a DTensor over the group's mesh, sync and async, and
    `step.global_mean` captured as one CUDA graph (warm-up on a side
    stream, `capture_error_mode="thread_local"`, as `make_multi_step`
    captures), then replayed on new inputs copied into the graph's
    buffers, each output against the same calls made eagerly on those
    inputs: bitwise. A group this phase formed is destroyed after."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    elif dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        fail(f"20a: this process already has a process group of "
             f"{dist.get_world_size()} ranks over {dist.get_backend()}")
    try:
        group = dist.group.WORLD
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("fsdp",))
        gen = torch.Generator(device="cuda").manual_seed(SEED + 90)
        x = torch.randn(256, 1024, device="cuda", generator=gen)
        w = torch.randn(768, 512, device="cuda", generator=gen)
        leaf = DTensor.from_local(w, mesh, [Shard(0)], run_check=False
                                  ).detach().requires_grad_(True)
        static = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            capture_collectives_run(group, static, leaf)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = capture_collectives_run(group, static, leaf)
        names = ("all_reduce", "gather_from", "sum_over",
                 "dgather_from (gather_from, sum_over backward)",
                 "dleaf (gather_for_use sync + async backward)",
                 "global_mean z", "global_mean sum_over")
        equal = {}
        for _ in range(3):
            new = torch.randn(x.shape, device="cuda", generator=gen)
            static.copy_(new)
            graph.replay()
            want = capture_collectives_run(group, new, leaf)
            torch.cuda.synchronize()
            for name, got, ref in zip(names, outs, want):
                equal[name] = equal.get(name, True) and torch.equal(got, ref)
        say(f"[20a] [{card}] a world-1 NCCL group (backend "
            f"{dist.get_backend()}): the port's collectives captured in one "
            f"CUDA graph and replayed on 3 new inputs, against eager calls: "
            + ", ".join(f"{k} bitwise {v}" for k, v in equal.items()))
        if not all(equal.values()):
            fail("20a: the replayed collectives differ from eager calls")
        del graph, outs
    finally:
        if own:
            dist.destroy_process_group()
        _free_cuda()
    return equal


# 20b's cases: (name, model, hparams over phase 7's), at world 2; those
# of MESH_WORLD4_CASES at world 4 with four cards.
MESH_CASES = (
    ("fsdp", "gpt2", {"mesh": {"fsdp": 2}}),
    ("fsdp_overlap", "gpt2", {"mesh": {"fsdp": 2},
                              "optimizations": {"overlap_allgather": True}}),
    ("data", "gpt2", {"mesh": {"data": 2}}),
    ("tensor", "gpt2", {"mesh": {"data": 1, "tensor": 2}}),
    ("context_ring", "gpt2", {"mesh": {"data": 1, "context": 2},
                              "attention_impl": "ring"}),
    ("context_ulysses", "gpt2", {"mesh": {"data": 1, "context": 2},
                                 "attention_impl": "ulysses"}),
    ("expert", "gpt2", {"mesh": {"data": 1, "expert": 2}, **MOE_HPARAMS}),
    ("pipeline", "gpt2", {"mesh": {"data": 1, "pipeline": 2}}),
    ("cifar_tensor", "cifar", {"mesh": {"data": 1, "tensor": 2},
                               "global_batch_size": CIFAR_BATCH}),
)
# With four cards the cases of world 2 run as two worlds at once, one on
# cards 0-1 and one on cards 2-3, split here by name (about even in time).
MESH_PAIR_SPLIT = {"fsdp", "fsdp_overlap", "data", "tensor", "context_ring"}
MESH_WORLD4_CASES = (
    ("fsdp_tensor", "gpt2", {"mesh": {"fsdp": 2, "tensor": 2}}),
    # MoE's count gather over a batch group of 2 ranks (`data`).
    ("expert_data", "gpt2", {"mesh": {"data": 2, "expert": 2},
                             **MOE_HPARAMS}),
)
MESH_FAULT_STEP = 2   # 20b's planted fault: rank 1 skips this batch's copy
# One rank of 20b, as `python mesh_worker.py ROOT OUT CASES_JSON`: each case
# of CASES_JSON in turn in one launched world (`mesh_case`), a RESULT line
# each. A case that raises ends the process (the launcher then takes the
# other ranks down: they would wait in a collective).
MESH_WORKER = r'''
import faulthandler, json, os, sys, time, traceback
ROOT, OUT, CASES = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, ROOT)
import torch
import chip_smoke
from determined_tpu_torch import core

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
t0 = time.monotonic()
ctx = core.init(max_length=1, checkpoint_dir=os.path.join(OUT, "ckpt"))
print(f"[20b] core.init {time.monotonic() - t0:.1f} s", flush=True)
for name, model, hparams in CASES:
    t0 = time.monotonic()
    try:
        out = chip_smoke.mesh_case(ctx, name, model, hparams)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    out["seconds"] = time.monotonic() - t0
    print("RESULT " + json.dumps(out), flush=True)
# Every thread's stack if the close takes a minute.
faulthandler.dump_traceback_later(60, exit=False)
t0 = time.monotonic()
ctx.close()
faulthandler.cancel_dump_traceback_later()
print(f"[20b] closed in {time.monotonic() - t0:.1f} s", flush=True)
'''


def _train_tensors(state):
    """(params, optimizer moments, extra): this rank's local tensors."""
    from determined_tpu_torch.core._checkpoint import _map_tensors
    from determined_tpu_torch.parallel import sharding
    from determined_tpu_torch.train.state import extra_leaves

    moments = []
    _map_tensors(state.opt_state, moments.append)
    return ([sharding.local_value(t) for t in state.leaves()], moments,
            list(extra_leaves(state.extra)))


def _max_abs(a, b):
    return max([float((x.float() - y.float()).abs().max())
                for x, y in zip(a, b)] or [0.0])


def mesh_case(ctx, name, model, hparams):
    """One case of 20b on this rank of a launched world (MESH_WORKER):
    the trial (phase 7's GPT-2 trial, or 13c's CIFAR ResNet-18) at
    `hparams` (phase 7's and the case's) over the mesh they name, built
    by `Trainer` as `fit` builds it, twice from one seed.
    `make_multi_step` (steps_per_call MULTI_STEPS) over MULTI_WINDOWS
    windows of the trial's own batches (this rank's rows) against as
    many `make_train_step` calls: the window means, this rank's params,
    optimizer moments and `extra`; the flash launches the graph holds,
    the wrapper's count and the replays made; each rank's peak memory of
    each. At `fsdp`, the planted
    fault: a third window through the same graph in which rank 1 replays
    step MESH_FAULT_STEP without refreshing its static batch, against the
    same window's eager steps; its window must fall outside the limits.
    One graph is alive at a time (the core's shutdown releases any graph
    still alive before it destroys the group: PERF.md §7). Then, as
    information: host ms a step, replay and
    eager in turns over a window each (replay, eager, eager, replay), and
    a window of each traced (`device_trace`): device and NCCL ms, idle
    share, and the flash kernels the replays ran on the card, which
    `phase_multi_mesh` holds to the graph's count. Every rank runs every
    call in the same order."""
    import numpy as np
    import torch

    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.step import make_multi_step, make_train_step
    from determined_tpu_torch.train.trial import TrialContext

    d = ctx.distributed
    hp = hparams
    Trial = cifar_trial_class() if model == "cifar" else gpt2_trial_class()
    trial = Trial(TrialContext(hparams=hp, core_context=ctx,
                               n_devices=d.size))
    if hp.get("optimizations"):
        # The experiment config's `optimizations:` block, which a launch
        # in local mode has not: set on the trial's model config.
        trial.cfg = dataclasses.replace(trial.cfg, **hp["optimizations"])
    trainer = Trainer(trial, core_context=ctx)

    def fresh():
        trainer._build(SEED)
        return trainer.state, trainer._tx, \
            torch.Generator(device="cuda").manual_seed(SEED + 1)

    replayed, tx_r, rng_r = fresh()
    eager, tx_e, rng_e = fresh()
    mesh = trainer.mesh
    if trainer.mesh_config.pipeline > 1:
        def loss(p, b, r):
            return trial.loss_pipelined(p, b, r, mesh)
    else:
        loss = trial.loss
    stream = trial.build_training_data()
    host = [next(stream) for _ in range(MULTI_STEPS * MULTI_WINDOWS)]
    windows = [{k: torch.from_numpy(np.stack([b[k] for b in host[
        w * MULTI_STEPS:(w + 1) * MULTI_STEPS]])).cuda() for k in host[0]}
        for w in range(MULTI_WINDOWS)]
    multi = make_multi_step(loss, tx_r, MULTI_STEPS, mesh=mesh,
                            stateful=trial.stateful)
    step = make_train_step(loss, tx_e, stateful=trial.stateful, mesh=mesh)

    def eager_window(w):
        ms = []
        for i in range(MULTI_STEPS):
            _, m = step(eager, {k: v[i] for k, v in w.items()}, rng_e)
            ms.append(m)
        return ms

    # The main path of 20b: every count starts at 0.
    for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    means_r = []
    for w in windows:
        _, m = multi(replayed, w, rng_r)
        means_r.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    peak_r = torch.cuda.max_memory_allocated() / 2 ** 30
    wrapper = {"flash_fwd": fa.flash_fwd_cuda.launches,
               "flash_dq": fa.flash_dq_cuda.launches,
               "flash_dkv": fa.flash_dkv_cuda.launches}
    torch.cuda.reset_peak_memory_stats()
    means_e = []
    for w in windows:
        ms = eager_window(w)
        means_e.append({k: float(step_order_sum([x[k] for x in ms])
                                 / MULTI_STEPS) for k in ms[0]})
    torch.cuda.synchronize()
    peak_e = torch.cuda.max_memory_allocated() / 2 ** 30
    rel = max(abs(mr[k] - me[k]) / max(abs(me[k]), 1e-12)
              for mr, me in zip(means_r, means_e)
              for k in ("loss", "grad_norm", "all_finite"))
    got, want = _train_tensors(replayed), _train_tensors(eager)
    diffs = {part: _max_abs(a, b) for part, a, b in zip(
        ("params", "moments", "extra"), got, want)}
    bitwise = all(v == 0.0 for v in diffs.values()) and all(
        mr[k] == me[k] for mr, me in zip(means_r, means_e) for k in mr)
    out = {"name": name, "rank": d.rank, "world": d.size,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
           "loss_r": [m["loss"] for m in means_r],
           "loss_e": [m["loss"] for m in means_e], "rel": rel,
           "diffs": diffs, "bitwise": bitwise,
           "graph": dict(multi._graph_launches), "replays": multi.replays,
           "wrapper": wrapper,
           "peak_gib": {"replay": peak_r, "eager": peak_e}}

    if name == "fsdp":
        # The planted fault, on the states the oracle left equal: a third
        # window through the same graph, in which rank 1 replays step
        # MESH_FAULT_STEP on its stale static batch, against the same
        # window's eager steps.
        if d.rank == 1:
            def stale(batches, i, copy=multi._copy_batch):
                if i != MESH_FAULT_STEP:
                    copy(batches, i)
            multi._copy_batch = stale
        _, m = multi(replayed, windows[0], rng_r)
        multi.__dict__.pop("_copy_batch", None)
        ms = eager_window(windows[0])
        out["fault_rel"] = max(
            abs(float(m[k]) - float(step_order_sum([x[k] for x in ms])
                                    / MULTI_STEPS))
            / max(abs(float(step_order_sum([x[k] for x in ms])
                            / MULTI_STEPS)), 1e-12)
            for k in ("loss", "grad_norm", "all_finite"))

    # Information: replayed against eager, in turns, then traced.
    w = windows[0]
    times = {"replay": [], "eager": []}
    run = {"replay": lambda: multi(replayed, w, rng_r),
           "eager": lambda: eager_window(w)}
    for mode in ("replay", "eager", "eager", "replay"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run[mode]()
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) * 1e3 / MULTI_STEPS)
    out["host_ms"] = times
    # A window of replays and one of eager steps, each traced: device
    # time, NCCL time, idle share, and the flash kernels that ran on the
    # card in the window's MULTI_STEPS replays.
    out["trace"] = {mode: device_trace(run[mode], MULTI_STEPS)
                    for mode in ("replay", "eager")}
    del multi, step, replayed, eager, trainer
    _free_cuda()
    return out


def launch_mesh_world(workdir, slots, cases, timeout, port,
                      worker=MESH_WORKER, tag="mesh"):
    """`worker` (MESH_WORKER, 20b's; FIT_MESH_WORKER, 22b's) through the
    port's launcher on the GPU slots `slots`, in local mode (no master),
    its rendezvous on `port` -> (each case's RESULT by rank, exit code,
    output). The launcher runs in a session of its own, killed whole at
    `timeout`."""
    import signal

    out = os.path.join(workdir, tag + "-".join(map(str, slots)))
    os.makedirs(out, exist_ok=True)
    script = os.path.join(out, f"{tag}_worker.py")
    with open(script, "w") as f:
        f.write(worker)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DET_") and k != "CUDA_VISIBLE_DEVICES"}
    env.update({"DET_SLOT_IDS": json.dumps(list(slots)),
                "DET_TORCH_MASTER_PORT": str(port),
                "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", "")})
    proc = subprocess.Popen(
        [sys.executable, "-m", "determined_tpu_torch.launch.torch_distributed",
         "--nproc-per-node", str(len(slots)), "--", sys.executable, script,
         ROOT, out, json.dumps(cases)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        log += f"\n[{tag}] killed at its limit of {timeout} s"
    results = {}
    for line in log.splitlines():
        if "RESULT " in line:
            r = json.loads(line.split("RESULT ", 1)[1])
            results.setdefault(r["name"], {})[r["rank"]] = r
    return results, proc.returncode, log


def mesh_launch_checks(name, ranks):
    """What is wrong with the flash launches of one case of 20b, from
    every rank's RESULT: the replays the oracle made (one window's step 0
    runs eagerly as the warm-up), the wrapper's count (the warm-up and
    the capture: twice the graph's), a GPT-2 graph holding flash
    launches (phase 7's formula at `fsdp`), and the flash kernels traced
    on the card in a window of MULTI_STEPS replays: the graph's count
    each."""
    L = 12
    want_fsdp = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}
    wrong = []
    for rank, r in sorted(ranks.items()):
        g = r["graph"]
        traced = r["trace"]["replay"]["flash"]
        if r["replays"] != MULTI_STEPS * MULTI_WINDOWS - 1:
            wrong.append(f"rank {rank} made {r['replays']} replays")
        if r["wrapper"] != {k: 2 * v for k, v in g.items()}:
            wrong.append(f"rank {rank}'s wrapper counted {r['wrapper']}, "
                         f"not twice the graph's {g}")
        if not name.startswith("cifar") and not sum(g.values()):
            wrong.append(f"rank {rank}'s graph holds no flash launch")
        if name.startswith("fsdp") and r["world"] == 2 and g != want_fsdp:
            wrong.append(f"rank {rank}'s graph holds {g}, not {want_fsdp}")
        if traced != {k: v * MULTI_STEPS for k, v in g.items()}:
            wrong.append(f"rank {rank}: {MULTI_STEPS} replays ran {traced} "
                         f"on the card, not {MULTI_STEPS} x {g}")
    return wrong


def phase_multi_mesh(workdir, hparams, card, cases=MESH_CASES,
                     per_case=False, timeout=900):
    """20b: with two cards or more, a launched world of 2 NCCL ranks runs
    the cases of MESH_CASES in turn (`mesh_case`); with four, two such
    worlds run at once (cards 0-1 and 2-3, the cases split by
    MESH_PAIR_SPLIT), then a world of 4 runs MESH_WORLD4_CASES. Each
    case's window means within MULTI_RTOL and every rank's params,
    optimizer moments and BatchNorm statistics within MULTI_PARAM_ATOL of
    the eager steps' (8a's limits); whether each is bitwise is printed;
    the flash launches as `mesh_launch_checks` holds them; the planted
    fault outside the limits. `per_case` launches a world for each case
    (a fault in one does not end the others). With one card: `[20b] not
    run: 1 card`."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        say(f"[20b] not run: {n} card")
        return None
    pair = [(c, m, {**hparams, **hp}) for c, m, hp in cases]
    if n >= 4:
        stages = [[((0, 1), [c for c in pair if c[0] in MESH_PAIR_SPLIT]),
                   ((2, 3), [c for c in pair
                             if c[0] not in MESH_PAIR_SPLIT])],
                  [((0, 1, 2, 3), [(c, m, {**hparams, **hp})
                                   for c, m, hp in MESH_WORLD4_CASES])]]
    else:
        stages = [[((0, 1), pair)]]
    results, failures = {}, []
    t0 = time.monotonic()
    for stage in stages:
        worlds = [(slots, part) for slots, group in stage if group
                  for part in ([[c] for c in group] if per_case
                               else [group])]
        for together in ([[w] for w in worlds] if per_case else [worlds]):
            ports = [free_port() for _ in together]
            with concurrent.futures.ThreadPoolExecutor(len(together)) as ex:
                runs = list(ex.map(
                    lambda w, port: launch_mesh_world(workdir, w[0], w[1],
                                                      timeout, port),
                    together, ports))
            for (slots, part), (got, rc, log) in zip(together, runs):
                results.update(got)
                missing = [c[0] for c in part
                           if sorted(got.get(c[0], {})) !=
                           list(range(len(slots)))]
                if rc != 0 or missing:
                    say(log[-6000:])
                    failures.append(f"world on cards {slots} exited {rc}; "
                                    f"no result from every rank for "
                                    f"{missing}")
    for name, ranks in results.items():
        r0 = ranks[0]
        worst = {"rel": max(r["rel"] for r in ranks.values())}
        for part in ("params", "moments", "extra"):
            worst[part] = max(r["diffs"][part] for r in ranks.values())
        bitwise = all(r["bitwise"] for r in ranks.values())
        wrong = mesh_launch_checks(name, ranks)
        say(f"[20b] [{card}] {name}, world {r0['world']}, mesh "
            f"{ {k: v for k, v in r0['mesh'].items() if v > 1} }: "
            f"make_multi_step({MULTI_STEPS}) x {MULTI_WINDOWS} against "
            f"{MULTI_STEPS * MULTI_WINDOWS} make_train_step calls: "
            f"window-mean losses {r0['loss_r']} / {r0['loss_e']}, max rel "
            f"diff of loss / grad_norm / all_finite {worst['rel']:.3e} "
            f"(rtol {MULTI_RTOL}); max |diff| over the ranks: params "
            f"{worst['params']:.3e}, moments {worst['moments']:.3e}, extra "
            f"{worst['extra']:.3e} (atol {MULTI_PARAM_ATOL}); bitwise "
            f"{bitwise}; flash launches the graph holds by rank "
            f"{[r['graph'] for r in ranks.values()]}, the wrapper's counts "
            f"{[r['wrapper'] for r in ranks.values()]}, {r0['replays']} "
            f"replays; traced on the card in {MULTI_STEPS} replays "
            f"{[r['trace']['replay']['flash'] for r in ranks.values()]}; "
            f"launch checks {'held' if not wrong else wrong}")
        h = r0["host_ms"]
        tr = {m: r0["trace"][m] for m in ("replay", "eager")}
        say(f"[20b] [{card}] {name} (information, rank 0): host ms a step, "
            f"replay {h['replay'][0]:.2f} / {h['replay'][1]:.2f}, eager "
            f"{h['eager'][0]:.2f} / {h['eager'][1]:.2f} (in turns); traced "
            f"a step (union of kernel intervals), " + "; ".join(
                f"{m}: device busy {t['busy_ms']:.2f} ms, NCCL "
                f"{t['nccl_ms']:.2f} ms ({t['nccl_only_ms']:.2f} with "
                f"nothing else running), host {t['wall_ms']:.2f} ms, idle "
                f"share {t['idle'] * 100:.1f}%" for m, t in tr.items())
            + f"; max_memory_allocated GiB by rank, replay "
            f"{[round(r['peak_gib']['replay'], 3) for r in ranks.values()]}"
            f", eager "
            f"{[round(r['peak_gib']['eager'], 3) for r in ranks.values()]}")
        if worst["rel"] > MULTI_RTOL or max(
                worst[p] for p in ("params", "moments", "extra")) > \
                MULTI_PARAM_ATOL:
            failures.append(f"{name}: the replays differ from the eager "
                            f"steps: {worst}")
        if wrong:
            failures.append(f"{name}: flash launches: {wrong}")
        if name == "fsdp":
            fault = max(r["fault_rel"] for r in ranks.values())
            say(f"[20b] [{card}] planted fault (rank 1 replays step "
                f"{MESH_FAULT_STEP} on its stale batch): window max rel diff "
                f"{fault:.3e}, refused: {fault > MULTI_RTOL}")
            if not fault > MULTI_RTOL:
                failures.append("the planted stale batch was not refused")
    say(f"[20b] [{card}] {time.monotonic() - t0:.1f} s")
    if failures:
        fail("20b: " + "; ".join(failures))
    return results


# ----------------------------------------------------------------- phase 21


FIT_FIRST, FIT_RESUMED = 15, 20  # 21a: fit to 15, then resume to 20
FIT_POISON_AT = 8        # the 8th batch drawn is non-finite (21a, 21c)
FIT_SIZES = (8, 8, 8, 3)  # 21a's rows a batch in turn: buckets 8 and 4
FIT_MEMORY_SIZES = {1: (8,), 3: (8, 3, 2)}  # buckets 8; 8, 4 and 2
FIT_TRACE_STEPS = 4
FIT_CIFAR_STEPS = 10
FIT_DIFFUSION_STEPS = 10


def fit_trial(base, eager, poison_at=None, sizes=None):
    """`base` (a trial class of the port) as phase 21 runs it: with
    `eager`, its optimizer without `hyper`, so that `fit` takes its eager
    route on the card (`step_route`: the run the captured one is held
    to); the `poison_at`-th training batch drawn non-finite through a flag
    a row that the loss reads on the device (no host read), under
    `health.on_nan: rollback`; the batches drawn in turn cut to `sizes`
    rows and bucketed (powers of two); one validation batch."""
    import itertools

    import numpy as np
    import torch

    from determined_tpu_torch.train import optim

    class Trial(base):
        health = {"on_nan": "rollback", "rollback_window": 1,
                  "max_rollbacks": 1}
        compile = {"bucket_batch_sizes": True, "upload": False} \
            if sizes else None

        def optimizer(self):
            tx = super().optimizer()
            return optim.GradientTransformation(tx.init, tx.update) \
                if eager else tx

        def build_training_data(self):
            for i, batch in enumerate(super().build_training_data()):
                if sizes:
                    n = sizes[i % len(sizes)]
                    batch = {k: v[:n] for k, v in batch.items()}
                if poison_at is not None:
                    rows = len(next(iter(batch.values())))
                    batch = dict(batch, poison=np.full(
                        rows, i + 1 == poison_at, np.float32))
                yield batch

        def build_validation_data(self):
            return itertools.islice(super().build_validation_data(), 1)

        if poison_at is not None:
            def loss(self, params, *args):
                # (batch, rng), or (extra, batch, rng) for a stateful trial.
                *extra, batch, rng = args
                out = super().loss(params, *extra, {
                    k: v for k, v in batch.items() if k != "poison"}, rng)
                # NaN loss and gradients on the poisoned batch.
                nan = torch.where((batch["poison"] > 0).any(), float("nan"),
                                  1.0)
                if isinstance(out, tuple):
                    return (out[0] * nan,) + tuple(out[1:])
                return out * nan

            def loss_pipelined(self, params, batch, rng, mesh):
                out = super().loss_pipelined(params, {
                    k: v for k, v in batch.items() if k != "poison"}, rng,
                    mesh)
                return out * torch.where((batch["poison"] > 0).any(),
                                         float("nan"), 1.0)

    Trial.__name__ = f"{base.__name__}{'Eager' if eager else ''}"
    return Trial


def fit_runs(trial_cls, hparams, ckpt_dir, fits, **fit_kwargs):
    """The fits `fits` ((max_length, resume_from), ...) of one trial class
    in a checkpoint directory of its own -> (every training report, the
    trainers, the last state, max_memory_allocated in GiB above what was
    allocated before the first fit: another run's live state and graphs
    are not this run's)."""
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.trial import TrialContext

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reports, trainers, state = [], [], None
    for length, resume in fits:
        ctx = core.init(max_length=length, checkpoint_dir=ckpt_dir)
        trainer = Trainer(trial_cls(TrialContext(hparams=hparams,
                                                 core_context=ctx)),
                          core_context=ctx)
        state = trainer.fit(resume_from=resume, **fit_kwargs)
        ctx.close()
        reports += ctx.train.local_training_metrics
        trainers.append(trainer)
    torch.cuda.synchronize()
    return reports, trainers, state, \
        (torch.cuda.max_memory_allocated() - before) / 2 ** 30


def held_to_eager(where, got, want):
    """The captured run `got` against the eager run `want` (each a
    fit_runs result): every report's step and its loss, grad_norm and
    all_finite (8a's MULTI_RTOL; a NaN window must be NaN in both), the
    final params, optimizer state and extra (MULTI_PARAM_ATOL). -> True
    when all are bitwise equal."""
    import math

    steps = [[r["steps_completed"] for r in run[0]] for run in (got, want)]
    worst_rel, bitwise = 0.0, steps[0] == steps[1]
    for g, w in zip(got[0], want[0]):
        for k in ("loss", "grad_norm", "all_finite"):
            a, b = float(g["metrics"][k]), float(w["metrics"][k])
            if math.isnan(a) or math.isnan(b):
                if not (math.isnan(a) and math.isnan(b)):
                    worst_rel, bitwise = math.inf, False
                continue
            bitwise = bitwise and a == b
            worst_rel = max(worst_rel, abs(a - b) / max(abs(b), 1e-12))
    diffs = {part: _max_abs(a, b) for part, a, b in zip(
        ("params", "moments", "extra"), _train_tensors(got[2]),
        _train_tensors(want[2]))}
    bitwise = bitwise and all(v == 0.0 for v in diffs.values())
    say(f"{where} captured against eager: reports at {steps[0]} (eager "
        f"{steps[1]}); losses {[round(float(r['metrics']['loss']), 4) for r in got[0]]}; "
        f"max rel diff of loss / grad_norm / all_finite {worst_rel:.3e} "
        f"(rtol {MULTI_RTOL}); final max |diff| {diffs} (atol "
        f"{MULTI_PARAM_ATOL}); bitwise equal: {bitwise}")
    if steps[0] != steps[1] or worst_rel > MULTI_RTOL or \
            max(diffs.values()) > MULTI_PARAM_ATOL:
        fail(f"{where} the captured fit differs from the eager fit")
    return bitwise


def phase_fit_captured(workdir, hparams, card):
    """21: `Trainer.fit` replaying its step on one card, against its eager
    route, each from one seed, captured first. 21a: GPT-2 small bf16 (B 8,
    S 1024, the example trial at phase 7's hparams) through 3 report
    windows, a non-finite step that rolls back, a checkpoint and a resume,
    with batches of 8 and 3 rows bucketed into 2 shapes: the reports and
    the final state held to the eager run's; the captured step's 2 graphs
    kept through the rollback (no new capture); its flash kernels traced
    in a replayed window against the graph's count x the replays; host ms
    a step (in turns), device busy ms (the union of kernel intervals),
    the idle share and `max_memory_allocated`, with 1 and 3 bucket shapes
    too. 21b: the stateful CIFAR trial, 10 steps, likewise. 21c: the DDPM
    UNet, whose loss draws from the step's generator, through a rollback
    that reseeds it."""
    import torch

    from determined_tpu_torch.ops import flash_attention as fa
    from determined_tpu_torch.train.trainer import _to_device

    GPT2Trial = gpt2_trial_class()
    fits = ((FIT_FIRST, None), (FIT_RESUMED, f"trial0-step{FIT_FIRST}"))
    kw = {"report_period": 5, "checkpoint_period": 5}
    out = {"peak_gib": {}}
    runs = {}
    for mode in ("captured", "eager"):
        cls = fit_trial(GPT2Trial, mode == "eager", FIT_POISON_AT, FIT_SIZES)
        for fn in (fa.flash_fwd_cuda, fa.flash_dq_cuda, fa.flash_dkv_cuda):
            fn.launches = 0
        t0 = time.monotonic()
        runs[mode] = fit_runs(cls, hparams, os.path.join(
            workdir, f"fit21_{mode}"), fits, **kw)
        wrapper = {"fwd": fa.flash_fwd_cuda.launches,
                   "dq": fa.flash_dq_cuda.launches,
                   "dkv": fa.flash_dkv_cuda.launches}
        reports, trainers = runs[mode][0], runs[mode][1]
        out["peak_gib"][f"{mode}_2"] = runs[mode][3]
        divergences = [r["steps_completed"] for r in reports
                       if r["metrics"].get("divergence")]
        firsts = [r["metrics"] for r in reports if "step_route" in r["metrics"]]
        say(f"[21a] [{card}] {mode}: fits to {FIT_FIRST} and resumed to "
            f"{FIT_RESUMED} in {time.monotonic() - t0:.1f} s; reports at "
            f"{[r['steps_completed'] for r in reports]}, divergence at "
            f"{divergences}; routes {[m['step_route'] for m in firsts]}; "
            f"flash wrapper launches {wrapper}; max_memory_allocated "
            f"{runs[mode][3]:.3f} GiB above what was live before")
        if divergences != [10] or len(firsts) != 2:
            fail(f"21a: the {mode} fit did not roll back once and resume")
        if mode == "captured":
            for t, m in zip(trainers, firsts):
                captured_fit_step(t, m, "[21a]", graphs=2)
            # Two captures a fit (a bucket each), the rollback none; one
            # validation batch a fit, its eval step captured.
            want = fit_launches(4, 2, 12)
            if wrapper != want:
                fail(f"21a: the flash wrappers ran {wrapper}, not {want}: a "
                     "capture more or less than the 2 buckets of 2 fits")
        elif any(m["step_captured"] != 0.0 or
                 not m["step_route"].startswith("eager:") for m in firsts):
            fail("21a: the comparison fit did not take the eager route")
    out["bitwise"] = {"21a": held_to_eager("[21a]", runs["captured"],
                                           runs["eager"])}

    # A window of B 8 steps on each route's last state, in turns.
    trial = runs["captured"][1][-1].trial
    data = trial.build_training_data()
    batches = []
    while len(batches) < FIT_TRACE_STEPS:
        b = next(data)
        if len(b["tokens"]) == 8:
            batches.append(_to_device(b, "cuda"))
    steps = {m: runs[m][1][-1] for m in runs}

    def window(mode):
        tr = steps[mode]
        rng = fit_rng(tr._train_step)
        for b in batches:
            tr._train_step(tr.state, b, rng)

    host = {"captured": [], "eager": []}
    for mode in ("captured", "eager", "eager", "captured"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        window(mode)
        torch.cuda.synchronize()
        host[mode].append((time.perf_counter() - t0) * 1e3 / FIT_TRACE_STEPS)
    traced = {m: device_trace(lambda m=m: window(m), FIT_TRACE_STEPS)
              for m in ("captured", "eager")}
    graph = steps["captured"]._train_step.graphs
    key = next(k for k in graph if k[0][1][0] == 8)
    want = {k: v * FIT_TRACE_STEPS for k, v in graph[key].launches.items()}
    for mode in ("captured", "eager"):
        t = traced[mode]
        say(f"[21a] [{card}] {mode}: host {host[mode][0]:.2f} / "
            f"{host[mode][1]:.2f} ms a step ({FIT_TRACE_STEPS} steps, in "
            f"turns); traced: host {t['wall_ms']:.2f} ms a step, device "
            f"busy {t['busy_ms']:.2f} ms (the union of kernel intervals), "
            f"idle share {t['idle'] * 100:.1f}%, flash kernels {t['flash']} "
            f"(pad kernels traced {t['pads']} of {2 * TRACE_PAD[0]})")
    if traced["captured"]["flash"] != want or \
            graph[key].launches["flash_fwd"] != 24:
        fail(f"21a: {FIT_TRACE_STEPS} replays launched "
             f"{traced['captured']['flash']} flash kernels, not the graph's "
             f"{graph[key].launches} x {FIT_TRACE_STEPS}")
    out.update(host=host, traced=traced, replayed_flash=traced["captured"][
        "flash"])
    del runs, steps, trial, data, batches, graph
    _free_cuda()

    # max_memory_allocated with 1 and 3 bucket shapes (2: above).
    for n, sizes in FIT_MEMORY_SIZES.items():
        run = fit_runs(fit_trial(GPT2Trial, False, None, sizes), hparams,
                       os.path.join(workdir, "fit21_memory"),
                       ((len(sizes) + 1, None),), report_period=5)
        step = run[1][0]._train_step
        out["peak_gib"][f"captured_{n}"] = run[3]
        say(f"[21a] [{card}] {len(sizes) + 1} captured steps over {n} bucket "
            f"shape(s): {len(step.graphs)} graph(s), max_memory_allocated "
            f"{run[3]:.3f} GiB above what was live before")
        if len(step.graphs) != n:
            fail(f"21a: {n} bucket shapes made {len(step.graphs)} graphs")
        del run, step
    _free_cuda()

    # 21b: the stateful CIFAR trial, 10 steps.
    CifarTrial = cifar_trial_class()
    hp = {"global_batch_size": CIFAR_BATCH}
    runs = {m: fit_runs(fit_trial(CifarTrial, m == "eager"), hp,
                        os.path.join(workdir, f"fit21_cifar_{m}"),
                        ((FIT_CIFAR_STEPS, None),), report_period=5)
            for m in ("captured", "eager")}
    captured_fit_step(runs["captured"][1][0], runs["captured"][0][0][
        "metrics"], "[21b]")
    out["bitwise"]["21b"] = held_to_eager("[21b] CIFAR ResNet-18",
                                          runs["captured"], runs["eager"])
    del runs
    _free_cuda()

    # 21c: the UNet draws its timesteps and noise from the step's
    # generator; the rollback reseeds it, and the replays must see it.
    ex = load_example("examples/diffusion_cuda/model_def.py",
                      "diffusion_cuda_fit21")
    hp = {**yaml_hparams(os.path.join(
        ROOT, "examples/diffusion_cuda/finetune_asha.yaml")),
        **DIFFUSION_POINT}
    runs = {m: fit_runs(fit_trial(ex.DiffusionTrial, m == "eager", 7), hp,
                        os.path.join(workdir, f"fit21_unet_{m}"),
                        ((FIT_DIFFUSION_STEPS, None),), **kw)
            for m in ("captured", "eager")}
    captured_fit_step(runs["captured"][1][0], runs["captured"][0][0][
        "metrics"], "[21c]")
    div = [r["steps_completed"] for r in runs["captured"][0]
           if r["metrics"].get("divergence")]
    if div != [10]:
        fail(f"21c: the UNet fit diverged at {div}, not once at 10")
    out["bitwise"]["21c"] = held_to_eager("[21c] DDPM UNet",
                                          runs["captured"], runs["eager"])
    del runs
    _free_cuda()
    return out


# ----------------------------------------------------------------- phase 22


EVAL22_ROWS = (8, 8, 3, 3)  # 22a's validation batches: 2 shapes, each twice
EVAL22_STEPS = 3            # 22a's fits: a pass at step 2, one at the op end


def eval22_trial(base):
    """`base` (GPT-2's example trial) with 22a's validation set: its
    batches cut to EVAL22_ROWS rows in turn, every batch's values its
    own."""
    class Trial(base):
        def build_validation_data(self):
            for n, batch in zip(EVAL22_ROWS, super().build_validation_data()):
                yield {k: v[:n] for k, v in batch.items()}

    Trial.__name__ = f"{base.__name__}Eval22"
    return Trial


def eager_eval_trainer():
    """A Trainer whose eval step is `make_eval_step`'s function, run
    eagerly: 22a's comparison route (nothing in the package takes it)."""
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.step import make_eval_step

    class EagerEval(Trainer):
        def _build_steps(self):
            super()._build_steps()
            self._eval_step = make_eval_step(self.trial.evaluate,
                                             stateful=self.trial.stateful)

    return EagerEval


def phase_eval_captured(workdir, hparams, card):
    """22a: `Trainer.fit` (phase 7's GPT-2 small, one card) with validation
    through its captured eval step and through the eager eval step, each
    fit EVAL22_STEPS steps with a pass at step 2 and one at the op end
    over EVAL22_ROWS (2 shapes): the validation metrics bitwise equal;
    the captured eval step holds 2 graphs and the flash wrappers count
    its 2 captures (`fit_launches`); the flush after its first call
    carries `eval_captured` 1.0 and `eval_route`, the first flush the
    train step's `step_captured` 1.0. Then passes over the captured fit's
    final state, captured and eager in turns: every pass's metrics
    bitwise the fit's last, host ms a pass; one pass of each traced
    (device busy ms, the union of kernel intervals) and the captured
    pass's flash kernels on the trace: its graphs' counts times their
    replays. `max_memory_allocated` above what was live, each fit."""
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train.step import (
        _CapturedEvalStep,
        make_eval_step,
    )
    from determined_tpu_torch.train.trial import TrialContext

    Trial = eval22_trial(gpt2_trial_class())
    runs, failures = {}, []
    for mode, cls in (("captured", Trainer), ("eager", eager_eval_trainer())):
        ckpt = os.path.join(workdir, f"eval22_{mode}")
        shutil.rmtree(ckpt, ignore_errors=True)
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        ctx = core.init(max_length=EVAL22_STEPS, checkpoint_dir=ckpt)
        trainer = cls(Trial(TrialContext(hparams=hparams, core_context=ctx)),
                      core_context=ctx)
        flash_counts(reset=True)
        t0 = time.monotonic()
        trainer.fit(report_period=1, validation_period=2)
        torch.cuda.synchronize()
        runs[mode] = {
            "ctx": ctx, "trainer": trainer, "wrapper": flash_counts(),
            "seconds": time.monotonic() - t0,
            "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2 ** 30,
            "val": [r["metrics"] for r in ctx.train.local_validation_metrics],
            "flushes": [r["metrics"] for r in
                        ctx.train.local_training_metrics]}
    cap, eag = runs["captured"], runs["eager"]
    tr, ctx = cap["trainer"], cap["ctx"]
    step = tr._eval_step
    graphs = step.graphs if isinstance(step, _CapturedEvalStep) else {}
    first = cap["flushes"][0]
    after = cap["flushes"][2] if len(cap["flushes"]) > 2 else {}
    want = fit_launches(1, 2, tr.trial.cfg.n_layer)
    bitwise = cap["val"] == eag["val"] and len(cap["val"]) == 2
    for mode, r in runs.items():
        say(f"[22a] [{card}] {mode} eval step: fit to {EVAL22_STEPS} in "
            f"{r['seconds']:.1f} s; validation {r['val']}; flash wrapper "
            f"launches {r['wrapper']}; max_memory_allocated "
            f"{r['peak_gib']:.3f} GiB above what was live before")
    say(f"[22a] [{card}] captured: {type(step).__name__} with {len(graphs)} "
        f"graph(s) (expected 2), wrapper launches {cap['wrapper']} "
        f"(expected {want}: the train step's warm-up and capture, the eval "
        f"step's 2); the first flush: step_captured "
        f"{first.get('step_captured')}, step_route "
        f"{first.get('step_route')!r}; the flush after the first pass: "
        f"eval_captured {after.get('eval_captured')}, eval_route "
        f"{after.get('eval_route')!r}; validation bitwise equal to the "
        f"eager eval step's: {bitwise}")
    if len(graphs) != 2 or cap["wrapper"] != want:
        failures.append("the captured eval step did not capture the 2 "
                        "shapes once each")
    if first.get("step_captured") != 1.0 or after.get("eval_captured") != \
            1.0 or not str(after.get("eval_route")).startswith("captured:") \
            or "step_route" in after:
        failures.append("the route keys are not the train and eval steps' "
                        "own")
    if not bitwise:
        failures.append("the captured eval step's validation differs from "
                        "the eager eval step's")

    # Passes over the captured fit's final state, in turns.
    steps = {"captured": step,
             "eager": make_eval_step(tr.trial.evaluate)}
    last = cap["val"][-1]

    def one_pass(mode):
        tr._eval_step = steps[mode]
        return tr._validate_inner(ctx, tr.state.step)

    host = {"captured": [], "eager": []}
    for mode in ("captured", "eager", "eager", "captured"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = one_pass(mode)
        host[mode].append((time.perf_counter() - t0) * 1e3)
        if got != last:
            failures.append(f"a {mode} pass read {got}, not {last}")
    traced = {m: device_trace(lambda m=m: one_pass(m), 1)
              for m in ("captured", "eager")}
    # A graph's key: (path, shape, dtype, device) a leaf; one leaf here.
    per_shape = {key[0][1][0]: g.launches for key, g in graphs.items()}
    replayed = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for rows in EVAL22_ROWS:
        for name, n in per_shape.get(rows, {}).items():
            replayed[name] += n
    for mode in ("captured", "eager"):
        t = traced[mode]
        say(f"[22a] [{card}] {mode} pass over {len(EVAL22_ROWS)} batches: host "
            f"{host[mode][0]:.2f} / {host[mode][1]:.2f} ms (in turns); "
            f"traced: host {t['wall_ms']:.2f} ms, device busy "
            f"{t['busy_ms']:.2f} ms (the union of kernel intervals), idle "
            f"share {t['idle'] * 100:.1f}%, flash kernels {t['flash']}")
    say(f"[22a] [{card}] the captured pass's flash kernels on the trace "
        f"{traced['captured']['flash']}, its graphs' {per_shape} x their "
        f"replays: {replayed}")
    if traced["captured"]["flash"] != replayed or \
            not replayed["flash_fwd"]:
        failures.append(f"a replayed pass ran {traced['captured']['flash']} "
                        f"flash kernels, not {replayed}")
    for r in runs.values():
        r["ctx"].close()
    out = {"host": host, "traced": traced, "bitwise": bitwise,
           "replayed_flash": traced["captured"]["flash"],
           "peak_gib": {m: r["peak_gib"] for m, r in runs.items()}}
    del runs, cap, eag, tr, ctx, step, steps, graphs
    _free_cuda()
    if failures:
        fail("22a: " + "; ".join(failures))
    return out


# 22b's fits: to step 4 (its op-end checkpoint), then resumed to 8 with
# the 3rd batch the resumed fit draws non-finite: the window 7-8 rolls
# back to step 4. Two checkpoints a fit pair: every save writes the whole
# train state to the card host's disk, which has a budget for a call.
FIT22_FIRST, FIT22_RESUMED = 4, 8
FIT22_POISON_AT = 3
FIT22_PERIOD = 2        # a report every 2 steps
# The fits' GPT-2 depth: GPT-2 small's width and 2 of its layers (a save
# of the 12-layer state writes 1.49 GB, moe.yaml's ~6.5 GB); the timed
# window builds the full depth and runs fit's step without a save.
FIT22_LAYERS = 2
FIT22_CASES = (
    ("fsdp", "gpt2", {"mesh": {"fsdp": 2}}),
    ("fsdp_overlap", "gpt2", {"mesh": {"fsdp": 2},
                              "optimizations": {"overlap_allgather": True}}),
    ("tensor", "gpt2", {"mesh": {"data": 1, "tensor": 2}}),
    ("context_ring", "gpt2", {"mesh": {"data": 1, "context": 2},
                              "attention_impl": "ring"}),
    ("pipeline", "gpt2", {"mesh": {"data": 1, "pipeline": 2}}),
    ("cifar_tensor", "cifar", {"mesh": {"data": 1, "tensor": 2},
                               "global_batch_size": CIFAR_BATCH}),
)
# MoE at `expert: 2`: with four cards a world of 4 (data 2), else of 2.
FIT22_EXPERT = {
    2: ("expert", "gpt2", {"mesh": {"data": 1, "expert": 2}, **MOE_HPARAMS}),
    4: ("expert_data", "gpt2", {"mesh": {"data": 2, "expert": 2},
                                **MOE_HPARAMS}),
}
# With four cards the world-2 cases run as two worlds at once.
FIT22_PAIR_SPLIT = {"fsdp", "fsdp_overlap", "tensor"}
# One rank of 22b, as `python fit_mesh_worker.py ROOT OUT CASES_JSON`:
# each case of CASES_JSON in turn (`fit_mesh_case`), a RESULT line each;
# the last case's trainers, graphs and all, stay alive through the close
# of the core contexts, which destroys the process group.
FIT_MESH_WORKER = r'''
import faulthandler, json, os, sys, time, traceback
ROOT, OUT, CASES = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
sys.path.insert(0, ROOT)
import torch
import chip_smoke
from determined_tpu_torch.core._distributed import DistributedContext

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dist = DistributedContext.from_env()
contexts, alive = [], []
for name, model, hparams in CASES:
    t0 = time.monotonic()
    try:
        out, alive = chip_smoke.fit_mesh_case(dist, name, model, hparams,
                                              OUT, contexts)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    out["seconds"] = time.monotonic() - t0
    print("RESULT " + json.dumps(out), flush=True)
graphs = sum(len(getattr(t._train_step, "graphs", {})) for t in alive)
# Every thread's stack, and an exit, if the close takes two minutes.
faulthandler.dump_traceback_later(120, exit=True)
t0 = time.monotonic()
for ctx in contexts:
    ctx.close()
faulthandler.cancel_dump_traceback_later()
print("CLOSED " + json.dumps({"rank": dist.rank, "graphs_alive": graphs,
                              "seconds": time.monotonic() - t0}), flush=True)
'''


def with_cfg(base, **changes):
    """`base` with its model config's fields `changes` set (an experiment
    config's `optimizations:` block, which a launch in local mode has
    not; a cut depth)."""
    class Trial(base):
        def __init__(self, context):
            super().__init__(context)
            self.cfg = dataclasses.replace(self.cfg, **changes)

    Trial.__name__ = base.__name__
    return Trial


def fit_mesh_case(dist, name, model, hparams, out, contexts):
    """One case of 22b on this rank of a launched world (FIT_MESH_WORKER):
    the trial (phase 7's GPT-2 trial at FIT22_LAYERS layers, or 13c's
    CIFAR ResNet-18) at `hparams` over the mesh they name, through
    `Trainer.fit` twice from one seed: captured (the route fit takes) and
    eager (an optimizer without `hyper`), each to FIT22_FIRST, then
    resumed to FIT22_RESUMED with the resumed fit's FIT22_POISON_AT-th
    batch non-finite (a rollback to FIT22_FIRST), one validation batch at
    each op end (the captured eval step on both). -> (this rank's
    readings, the timed window's trainers): the chief's reports and
    validation, this rank's params, moments and extra, the first
    flushes' routes, the graphs; then, as information, the trial at its
    full depth built by `Trainer` as fit builds it on each route, a
    window of FIT_TRACE_STEPS calls of fit's step in turns (host ms),
    each traced (device busy, NCCL, idle share, the flash kernels), the
    vote's host us a captured call, each route's peak memory. `contexts`
    collects the core contexts (closing one destroys the process group).
    Every rank makes every call in the same order."""
    import shutil

    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.train import Trainer
    from determined_tpu_torch.train import step as step_mod
    from determined_tpu_torch.train.trainer import _to_device
    from determined_tpu_torch.train.trial import TrialContext

    cuda = os.environ.get("DET_TORCH_BACKEND", "nccl") == "nccl"
    device = "cuda" if cuda else "cpu"
    full = cifar_trial_class() if model == "cifar" else gpt2_trial_class()
    if hparams.get("optimizations"):
        full = with_cfg(full, **hparams["optimizations"])
    cut = full if model == "cifar" else with_cfg(full, n_layer=FIT22_LAYERS)

    def trainer_of(cls, length, ckpt):
        ctx = core.init(max_length=length, distributed=dist,
                        checkpoint_dir=ckpt)
        contexts.append(ctx)
        return Trainer(cls(TrialContext(hparams=hparams, core_context=ctx,
                                         n_devices=dist.size)),
                       core_context=ctx, device=device), ctx

    runs = {}
    for mode in ("captured", "eager"):
        ckpt = os.path.join(out, f"fit22_{name}_{mode}")
        if dist.is_chief:
            shutil.rmtree(ckpt, ignore_errors=True)
        dist.barrier()
        if cuda:
            _free_cuda()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        reports, vals, state = [], [], None
        for length, resume, poison in (
                (FIT22_FIRST, None, None),
                (FIT22_RESUMED, f"trial0-step{FIT22_FIRST}", FIT22_POISON_AT)):
            trainer, ctx = trainer_of(
                fit_trial(cut, mode == "eager", poison), length, ckpt)
            state = trainer.fit(resume_from=resume,
                                report_period=FIT22_PERIOD)
            reports += ctx.train.local_training_metrics
            vals += ctx.train.local_validation_metrics
        peak = None
        if cuda:
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
        runs[mode] = {"reports": reports, "vals": vals, "trainer": trainer,
                      "state": state, "peak_gib": peak}
    cap, eag = runs["captured"], runs["eager"]
    firsts = {m: [r["metrics"] for r in runs[m]["reports"]
                  if "step_route" in r["metrics"]] for m in runs}
    rel, nan_ok = 0.0, True
    for g, w in zip(cap["reports"], eag["reports"]):
        for k in ("loss", "grad_norm", "all_finite"):
            a, b = float(g["metrics"][k]), float(w["metrics"][k])
            if math.isnan(a) or math.isnan(b):
                nan_ok = nan_ok and math.isnan(a) and math.isnan(b)
                continue
            rel = max(rel, abs(a - b) / max(abs(b), 1e-12))
    diffs = {part: _max_abs(a, b) for part, a, b in zip(
        ("params", "moments", "extra"), _train_tensors(cap["state"]),
        _train_tensors(eag["state"]))}

    def readings(run):
        return [(r["steps_completed"], r["metrics"].get("loss"),
                 r["metrics"].get("grad_norm")) for r in run["reports"]]

    mesh = cap["trainer"].mesh
    result = {
        "name": name, "rank": dist.rank, "world": dist.size,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        "steps": [r["steps_completed"] for r in cap["reports"]],
        "steps_eager": [r["steps_completed"] for r in eag["reports"]],
        "divergence": [r["steps_completed"] for r in cap["reports"]
                       if r["metrics"].get("divergence")],
        "losses": [r["metrics"]["loss"] for r in cap["reports"]],
        "rel": rel, "nan_ok": nan_ok, "diffs": diffs,
        "bitwise": str(readings(cap)) == str(readings(eag)) and nan_ok
        and all(v == 0.0 for v in diffs.values()),
        "vals": [r["metrics"] for r in cap["vals"]],
        "vals_eager": [r["metrics"] for r in eag["vals"]],
        "routes": {m: [(f.get("step_captured"), f.get("step_route"))
                       for f in firsts[m]] for m in firsts},
        "graphs": len(getattr(cap["trainer"]._train_step, "graphs", {})),
        "eval_graphs": len(getattr(cap["trainer"]._eval_step, "graphs",
                                   {})),
        "peak_gib": {m: r["peak_gib"] for m, r in runs.items()}}
    del runs, cap, eag, state
    if not cuda:
        return result, []

    # Information: fit's step at the full depth on each route, as fit
    # builds it, a window of calls in turns, then each traced.
    _free_cuda()
    trainers, peaks = {}, {}
    for mode in ("captured", "eager"):
        trainers[mode], _ = trainer_of(fit_trial(full, mode == "eager"), 1,
                                       os.path.join(out, f"fit22_{name}"))
        trainers[mode]._build(SEED)
    data = trainers["captured"].trial.build_training_data()
    batches = [_to_device(next(data), "cuda") for _ in range(FIT_TRACE_STEPS)]
    rngs = {m: torch.Generator(device="cuda").manual_seed(SEED + 1)
            for m in trainers}
    votes = []
    agree = step_mod._agree

    def timed(*a, **k):
        t0 = time.perf_counter()
        got = agree(*a, **k)
        votes.append(time.perf_counter() - t0)
        return got

    def window(mode):
        t = trainers[mode]
        for b in batches:
            t._train_step(t.state, b, rngs[mode])

    for mode in trainers:   # the captured step's first call captures
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        window(mode)
        torch.cuda.synchronize()
        peaks[mode] = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
    step_mod._agree = timed
    try:
        host = {"captured": [], "eager": []}
        for mode in ("captured", "eager", "eager", "captured"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            window(mode)
            torch.cuda.synchronize()
            host[mode].append((time.perf_counter() - t0) * 1e3
                              / FIT_TRACE_STEPS)
        traced = {m: device_trace(lambda m=m: window(m), FIT_TRACE_STEPS)
                  for m in ("captured", "eager")}
    finally:
        step_mod._agree = agree
    graph = next(iter(trainers["captured"]._train_step.graphs.values()))
    result.update(host_ms=host, trace=traced,
                  graph_launches=dict(graph.launches),
                  window_peak_gib=peaks,
                  vote_us=[v * 1e6 for v in votes])
    del batches, graph
    return result, list(trainers.values())


def fit_mesh_checks(name, ranks):
    """What is wrong with one case of 22b, from every rank's RESULT."""
    wrong = []
    r0 = ranks[0]
    if r0["divergence"] != [FIT22_RESUMED] or \
            r0["steps"] != r0["steps_eager"]:
        wrong.append(f"reports at {r0['steps']} (eager {r0['steps_eager']}),"
                     f" divergence at {r0['divergence']}")
    caps = r0["routes"]["captured"]
    if len(caps) != 2 or any(c != 1.0 or not str(w).startswith("captured:")
                             for c, w in caps):
        wrong.append(f"the captured fits' first flushes read "
                     f"{r0['routes']['captured']}")
    if any(c != 0.0 for c, _ in r0["routes"]["eager"]):
        wrong.append(f"the eager fits' first flushes read "
                     f"{r0['routes']['eager']}")
    if r0["vals"] != r0["vals_eager"] or len(r0["vals"]) != 2:
        wrong.append(f"validation {r0['vals']} against {r0['vals_eager']}")
    for rank, r in sorted(ranks.items()):
        if r["graphs"] != 1 or r["eval_graphs"] != 1:
            wrong.append(f"rank {rank}: {r['graphs']} train and "
                         f"{r['eval_graphs']} eval graphs, not 1 and 1")
        if "trace" in r and not name.startswith("cifar"):
            g, traced = r["graph_launches"], r["trace"]["captured"]["flash"]
            want = {k: v * FIT_TRACE_STEPS for k, v in g.items()}
            if traced != want or not sum(g.values()):
                wrong.append(f"rank {rank}: {FIT_TRACE_STEPS} replays ran "
                             f"{traced} flash kernels, not {want}")
    return wrong


def phase_fit_mesh(workdir, hparams, card, per_case=False, timeout=900):
    """22b: with two cards or more, `Trainer.fit` over a mesh of 2 NCCL
    ranks (with four cards two such worlds at once, cards 0-1 and 2-3,
    then a world of 4 for MoE at `data: 2, expert: 2`) through the
    port's launcher in local mode, each case of FIT22_CASES (and
    FIT22_EXPERT) captured against its eager route (`fit_mesh_case`):
    the reports within MULTI_RTOL, every rank's params, moments and extra
    within MULTI_PARAM_ATOL, the validation equal, bitwise printed; the
    checks of `fit_mesh_checks`; every world's close (process group
    destroyed with the last case's graphs alive) returning. Information:
    rank 0's host ms a step in turns, traced device busy and NCCL ms,
    idle share, the vote's host us, each rank's peak. With one card:
    `[22b] not run: 1 card`."""
    import itertools

    import torch

    n = torch.cuda.device_count()
    if n < 2:
        say(f"[22b] not run: {n} card")
        return None
    cases = [(c, m, {**hparams, **hp}) for c, m, hp in FIT22_CASES]
    expert = FIT22_EXPERT[4 if n >= 4 else 2]
    expert = (expert[0], expert[1], {**hparams, **expert[2]})
    if n >= 4:
        stages = [[((0, 1), [c for c in cases if c[0] in FIT22_PAIR_SPLIT]),
                   ((2, 3), [c for c in cases
                             if c[0] not in FIT22_PAIR_SPLIT])],
                  [((0, 1, 2, 3), [expert])]]
    else:
        stages = [[((0, 1), cases + [expert])]]
    results, failures, closes = {}, [], []
    t0 = time.monotonic()
    for stage in stages:
        # The stage's worlds run at once; `per_case`: a world a case, the
        # i-th case of each group's at once.
        rounds = [[(slots, group) for slots, group in stage if group]]
        if per_case:
            rounds = [[w for w in ws if w is not None]
                      for ws in itertools.zip_longest(*[
                          [(slots, [c]) for c in group]
                          for slots, group in stage])]
        for together in rounds:
            ports = [free_port() for _ in together]
            with concurrent.futures.ThreadPoolExecutor(len(together)) as ex:
                runs = list(ex.map(
                    lambda w, port: launch_mesh_world(
                        workdir, w[0], w[1], timeout, port, FIT_MESH_WORKER,
                        "fit_mesh"), together, ports))
            for (slots, part), (got, rc, log) in zip(together, runs):
                results.update(got)
                closed = [json.loads(line.split("CLOSED ", 1)[1])
                          for line in log.splitlines() if "CLOSED " in line]
                closes.append((slots, closed))
                missing = [c[0] for c in part
                           if sorted(got.get(c[0], {})) !=
                           list(range(len(slots)))]
                if rc != 0 or missing or len(closed) != len(slots):
                    say(log[-6000:])
                    failures.append(f"world on cards {slots} exited {rc}; "
                                    f"no result from every rank for "
                                    f"{missing}; closed {closed}")
    for slots, closed in closes:
        say(f"[22b] [{card}] world on cards {slots}: the core contexts "
            f"closed (destroy_process_group) with the last case's graphs "
            f"alive: " + ", ".join(
                f"rank {c['rank']} {c['seconds']:.2f} s, {c['graphs_alive']}"
                f" graph(s)" for c in closed))
    for name, ranks in results.items():
        r0 = ranks[0]
        worst = {"rel": max(r["rel"] for r in ranks.values())}
        for part in ("params", "moments", "extra"):
            worst[part] = max(r["diffs"][part] for r in ranks.values())
        bitwise = all(r["bitwise"] for r in ranks.values())
        wrong = fit_mesh_checks(name, ranks)
        say(f"[22b] [{card}] {name}, world {r0['world']}, mesh "
            f"{ {k: v for k, v in r0['mesh'].items() if v > 1} }: fit "
            f"captured against eager, reports at {r0['steps']}, divergence "
            f"at {r0['divergence']}, losses "
            f"{[round(float(x), 4) for x in r0['losses']]}; max rel diff of "
            f"loss / grad_norm / all_finite {worst['rel']:.3e} (rtol "
            f"{MULTI_RTOL}); max |diff| over the ranks: params "
            f"{worst['params']:.3e}, moments {worst['moments']:.3e}, extra "
            f"{worst['extra']:.3e} (atol {MULTI_PARAM_ATOL}); bitwise "
            f"{bitwise}; validation {r0['vals']} / {r0['vals_eager']}; "
            f"routes {r0['routes']['captured'][:1]}; checks "
            f"{'held' if not wrong else wrong}")
        if "trace" in r0:
            h, tr = r0["host_ms"], r0["trace"]
            votes = r0["vote_us"]
            say(f"[22b] [{card}] {name} (information, rank 0): host ms a "
                f"step, captured {h['captured'][0]:.2f} / "
                f"{h['captured'][1]:.2f}, eager {h['eager'][0]:.2f} / "
                f"{h['eager'][1]:.2f} (in turns); traced a step, " +
                "; ".join(
                    f"{m}: device busy {t['busy_ms']:.2f} ms, NCCL "
                    f"{t['nccl_ms']:.2f} ms ({t['nccl_only_ms']:.2f} with "
                    f"nothing else running), host {t['wall_ms']:.2f} ms, "
                    f"idle share {t['idle'] * 100:.1f}%, flash {t['flash']}"
                    for m, t in tr.items())
                + f"; the vote's host us a captured call: mean "
                f"{statistics.mean(votes):.1f}, max {max(votes):.1f} over "
                f"{len(votes)}; max_memory_allocated GiB by rank above what "
                f"was live, the fits at {FIT22_LAYERS} layers, captured "
                f"{[round(r['peak_gib']['captured'], 3) for r in ranks.values()]}"
                f", eager "
                f"{[round(r['peak_gib']['eager'], 3) for r in ranks.values()]}"
                f"; the full-depth window's first calls (the capture), "
                f"captured "
                f"{[round(r['window_peak_gib']['captured'], 3) for r in ranks.values()]}"
                f", eager "
                f"{[round(r['window_peak_gib']['eager'], 3) for r in ranks.values()]}")
        if worst["rel"] > MULTI_RTOL or max(
                worst[p] for p in ("params", "moments", "extra")) > \
                MULTI_PARAM_ATOL or not r0["nan_ok"]:
            failures.append(f"{name}: the captured fit differs from the "
                            f"eager fit: {worst}")
        if wrong:
            failures.append(f"{name}: {wrong}")
    say(f"[22b] [{card}] {time.monotonic() - t0:.1f} s")
    if failures:
        fail("22b: " + "; ".join(failures))
    return results


# ----------------------------------------------------------------- phase 23


AUTOTUNE = {"start_size": 16, "max_size": 256, "profile_steps": 4}
AUTOTUNE_FIXTURE = os.path.join("tests", "fixtures", "platform_torch",
                                "autotune_gpt2.py")
OOM_ERROR = "torch.OutOfMemoryError"


class SearchMaster(FakeMaster):
    """23a's master: FakeMaster speaking the custom-searcher protocol as
    the native master does (native/master/master_api.cc:418-470,
    master_experiments.cc `process_ops_locked` and `finish_trial_locked`,
    searcher.h `CustomSearch`). Experiment create queues
    `initial_operations`; `searcher_events` long-polls the unacked events;
    `searcher_operations` acks them and applies the client's operations: a
    Create makes a trial, its ValidateAfter starts the trial (`launch(master,
    trial)`, in a thread) or hands it the length, a Close ends it (at once
    when it is not running, else its next op poll answers `done`), a
    Shutdown completes the experiment once no trial runs. A trial's
    completed operation becomes `validation_completed`; a trial that exits 0
    becomes `trial_closed`, one that exits non-zero `trial_exited_early`
    ("errored"). Preemption polls answer at once, so a closing trial does
    not wait out a long-poll."""

    def __init__(self, launch):
        super().__init__()
        self._launch = launch
        self._cv = threading.Condition()
        self._next_event = 1
        self.events, self.operations, self.trials = [], [], {}
        self.state = "ACTIVE"
        self.config = self.shutdown = None

    def _push(self, etype, data):
        self.events.append({"id": self._next_event, "type": etype,
                            "data": data})
        self._next_event += 1
        self._cv.notify_all()

    def _apply(self, op):
        kind = op["type"]
        if kind == "Create":
            self.trials[op["request_id"]] = {
                "id": len(self.trials) + 1, "request_id": op["request_id"],
                "hparams": op["hparams"], "ops": [], "close": False,
                "state": "ACTIVE", "running": False}
        elif kind == "ValidateAfter":
            t = self.trials[op["request_id"]]
            t["ops"].append(op["length"])
            if not t["running"] and t["state"] == "ACTIVE":
                t["running"] = True
                threading.Thread(target=self._run, args=(t,),
                                 daemon=True).start()
        elif kind == "Close":
            t = self.trials[op["request_id"]]
            t["close"] = True
            if not t["running"]:
                self._finish(t, "COMPLETED")
        elif kind == "Shutdown":
            self.shutdown = op

    def _finish(self, t, state):
        if t["state"] != "ACTIVE":
            return
        t["state"] = state
        if state == "ERROR":
            self._push("trial_exited_early",
                       {"request_id": t["request_id"], "reason": "errored"})
        else:
            self._push("trial_closed", {"request_id": t["request_id"]})

    def _complete_if_done(self):
        if self.shutdown is not None and not any(
                t["running"] for t in self.trials.values()):
            self.state = "COMPLETED"
            self._cv.notify_all()

    def _run(self, t):
        rc, log, wall = self._launch(self, t)
        with self._cv:
            t.update(running=False, rc=rc, log=log, wall_s=wall)
            self._finish(t, "COMPLETED" if rc == 0 else "ERROR")
            self._complete_if_done()

    def _trial(self, trial_id):
        return next(t for t in self.trials.values() if t["id"] == trial_id)

    def _wait(self, done, timeout):
        end = time.monotonic() + timeout
        while not done() and time.monotonic() < end:
            self._cv.wait(end - time.monotonic())

    def answer(self, method, path, query, body):
        if path.endswith("/signals/preemption"):
            time.sleep(0.2)
            return {}
        if path == "/api/v1/auth/login":
            return {"token": "smoke"}
        m = re.fullmatch(r"/api/v1/trials/(\d+)/searcher/(\w+)", path)
        with self._cv:
            if method == "POST" and path == "/api/v1/experiments":
                self.config = body["config"]
                self._push("initial_operations", {})
                return {"id": 1, "experiment": {"id": 1, "state": "ACTIVE"}}
            if path.endswith("/searcher_events"):
                self._wait(lambda: self.events or self.state != "ACTIVE",
                           float(query.get("timeout_seconds", 30)))
                return {"events": list(self.events),
                        "experiment_state": self.state}
            if path.endswith("/searcher_operations"):
                acked = body["triggered_by_event_id"]
                self.events = [e for e in self.events if e["id"] > acked]
                for op in body["operations"]:
                    self.operations.append(op)
                    self._apply(op)
                self._complete_if_done()
                self._cv.notify_all()  # a Close or a length for a poll
                return {}
            if m and m.group(2) == "operation":
                t, last = self._trial(int(m.group(1))), int(query["last"])
                self._wait(lambda: any(n > last for n in t["ops"]) or
                           t["close"], float(query["timeout_seconds"]))
                ahead = [n for n in t["ops"] if n > last]
                return ({"op": {"length": ahead[0]}} if ahead else
                        {"done": True} if t["close"] else {})
            if m and m.group(2) == "completed_operation":
                t = self._trial(int(m.group(1)))
                t["ops"].remove(body["length"])
                t["metric"] = body["searcher_metric"]
                self._push("validation_completed", {
                    "request_id": t["request_id"],
                    "metric": body["searcher_metric"],
                    "length": body["length"]})
                return {}
        return super().answer(method, path, query, body)


def launch_search_trial(workdir, storage):
    """-> launch(master, trial) for SearchMaster: the autotune fixture
    through the port's launcher on GPU slot 0, with the variables an agent
    sets and this script's built kernels (no trial pays nvcc); the log
    goes to workdir/trial-<id>.log."""
    script = os.path.join(ROOT, AUTOTUNE_FIXTURE)

    def launch(master, t):
        env = dict(os.environ)
        for k in ("DET_TORCH_BACKEND", "CUDA_VISIBLE_DEVICES",
                  "DET_COMPILE_SIGNATURE"):
            env.pop(k, None)
        env.update({
            "DET_MASTER": master.url, "DET_TRIAL_ID": str(t["id"]),
            "DET_EXPERIMENT_ID": "1", "DET_SESSION_TOKEN": "smoke",
            "DET_ALLOCATION_ID": f"autotune-{t['id']}",
            "DET_HPARAMS": json.dumps(t["hparams"]),
            "DET_EXPERIMENT_CONFIG": json.dumps(master.config),
            "DET_TORCH_MASTER_PORT": str(free_port()),
            "DET_SLOT_IDS": "[0]",
            "DET_KERNEL_DIR": os.path.join(ROOT, "build", "kernels"),
            "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", "")})
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m",
             "determined_tpu_torch.launch.torch_distributed",
             "--nproc-per-node", "1", "--", sys.executable, script],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=900)
        log = proc.stdout + proc.stderr
        with open(os.path.join(workdir, f"trial-{t['id']}.log"), "w") as f:
            f.write(log)
        return proc.returncode, log, time.monotonic() - t0

    return launch


def preflight_gib(hparams, batch):
    """The port's estimate of GPT-2 small's fit at `batch` rows, one card,
    on the meta device: {total, activations} GiB."""
    from determined_tpu_torch.analysis import analyze_trial
    from determined_tpu_torch.train.trial import TrialContext

    _, hbm, _ = analyze_trial(gpt2_trial_class()(TrialContext(
        hparams={**hparams, "global_batch_size": batch})), 1)
    return {"total": hbm["total_bytes"] / 2 ** 30,
            "activations": hbm["activations_upper_bound_bytes"] / 2 ** 30}


def phase_autotune(workdir, hparams, card):
    """23a: the port's batch-size autotune over GPT-2 small on the card.
    The port's RemoteSearchRunner drives the port's BatchSizeSearchMethod
    through the port's `Determined` client against SearchMaster; each
    Create is the autotune fixture (examples/gpt2_cuda's GPT2Trial through
    fit's replayed step at phase 7's hparams and the size the search
    names) launched on slot 0. Each size: samples/s, the trial's
    `max_memory_allocated`, wall time and end; then the best size, the
    failed sizes, the search's wall time, and the preflight's estimate at
    the best and the smallest failed size beside the card's memory. Fails
    if a failed trial's log lacks torch.OutOfMemoryError, a failed size
    was not retried once, a size below the best failed, the search did
    not reach Shutdown, or a trial that fit launched no flash kernel (its
    wrappers' counts: the warm-up, the capture and the eval step's)."""
    import shutil

    import torch

    from determined_tpu_torch.autotune import BatchSizeSearchMethod
    from determined_tpu_torch.experimental import Determined
    from determined_tpu_torch.searcher import RemoteSearchRunner

    _free_cuda()
    free, total_bytes = torch.cuda.mem_get_info()
    say(f"[23a] [{card}] before the search: {free / 2 ** 30:.3f} of "
        f"{total_bytes / 2 ** 30:.3f} GiB free on the card (this process "
        f"reserves {torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB)")
    out_dir = os.path.join(workdir, "autotune")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    storage = os.path.join(out_dir, "checkpoints")
    master = SearchMaster(launch_search_trial(out_dir, storage))
    base = {k: v for k, v in hparams.items() if k != "global_batch_size"}
    method = BatchSizeSearchMethod(base_hparams=base, **AUTOTUNE)
    config = {
        "name": "autotune-gpt2-small",
        "entrypoint": "python3 -m determined_tpu_torch.launch."
                      f"torch_distributed -- python3 {AUTOTUNE_FIXTURE}",
        "searcher": {"name": "custom", "metric": "samples_per_second",
                     "smaller_is_better": False},
        "checkpoint_storage": {"type": "shared_fs", "host_path": storage},
        "resources": {"slots_per_trial": 1}, "max_restarts": 0}
    t0 = time.monotonic()
    try:
        runner = RemoteSearchRunner(method, client=Determined(master.url))
        eid = runner.run(config, poll_timeout=30)
    finally:
        master.release()
        master.close()
    wall = time.monotonic() - t0
    shutil.rmtree(storage, ignore_errors=True)

    trials = sorted(master.trials.values(), key=lambda t: t["id"])
    rows, problems = [], []
    for t in trials:
        size = t["hparams"]["global_batch_size"]
        result = None
        for line in t.get("log", "").splitlines():
            if "RESULT " in line:  # the launcher prefixes "[rank=0] "
                result = json.loads(line.split("RESULT ", 1)[1])
        if t.get("rc") == 0 and result is not None:
            end = "fit"
            if min(result["launches"].values()) == 0 or \
                    result["launches"] != fit_launches(1, 1, 12):
                problems.append(f"size {size}: flash launches "
                                f"{result['launches']}")
        else:
            oom = re.findall(r"Tried to allocate [\d.]+ [GMK]iB",
                             t.get("log", ""))
            where = re.findall(r'File "[^"]*/([^/"]+)", line (\d+), in (\w+)',
                               t.get("log", ""))
            end = f"exit {t.get('rc')}: " + (
                f"{OOM_ERROR} ({oom[0] if oom else 'no size'}; raised in "
                + " <- ".join(f"{fn} ({f}:{n})" for f, n, fn in
                              where[::-1][:6]) + ")"
                if OOM_ERROR in t.get("log", "") else "NOT out of memory")
            if OOM_ERROR not in t.get("log", ""):
                say(t.get("log", "")[-3000:])
                problems.append(f"size {size} failed without {OOM_ERROR}")
        rows.append({"trial": t["id"], "size": size, "end": end,
                     "wall_s": t.get("wall_s"), "result": result})
        r = result or {}
        say(f"[23a] [{card}] trial {t['id']}, global_batch_size {size}: "
            f"{end}; samples/s {r.get('samples_per_second')}, steps ms "
            f"{r.get('step_ms')}, max_memory_allocated {r.get('peak_gib')} "
            f"GiB, {r.get('step_route')}; wall {t.get('wall_s', 0):.1f} s")
    best, sps = method.best()
    failed = sorted(method.failed_sizes)
    tries = {}
    for row in rows:
        tries.setdefault(row["size"], []).append(row["end"] == "fit")
    for size in failed:
        if tries[size] != [False, False]:
            problems.append(f"size {size}: tries {tries[size]}, want two "
                            "failures (one retry)")
    below = [row["size"] for row in rows
             if row["end"] != "fit" and row["size"] < best]
    if below:
        problems.append(f"sizes {below} below the best {best} failed")
    shut = master.shutdown
    if master.state != "COMPLETED" or shut is None or shut.get("cancel"):
        problems.append(f"the search ended {master.state} with Shutdown "
                        f"{shut}")
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    estimates = {best: preflight_gib(hparams, best)}
    if failed:
        estimates[failed[0]] = preflight_gib(hparams, failed[0])
    say(f"[23a] [{card}] experiment {eid}: {len(trials)} trials in "
        f"{wall:.1f} s; best global_batch_size {best}, {sps:.2f} samples/s "
        f"({sps * hparams['seq_len']:.0f} tokens/s); failed sizes {failed}; "
        f"progress {method.progress()}; operations "
        f"{[op['type'] for op in master.operations]}")
    for size, g in estimates.items():
        say(f"[23a] [{card}] preflight at B {size}: total {g['total']:.4f} "
            f"GiB, total + activations {g['total'] + g['activations']:.4f} "
            f"GiB; the card's memory {total:.4f} GiB")
    if problems:
        fail("23a: " + "; ".join(problems))
    launches = {k: sum(row["result"]["launches"][k] for row in rows
                       if row["result"]) for k in ("fwd", "dq", "dkv")}
    return {"best": best, "samples_per_second": sps, "failed": failed,
            "rows": rows, "wall_s": wall, "estimates": estimates,
            "card_gib": total, "launches": launches}


DET_PREFLIGHT_CONFIG = os.path.join("examples", "gpt2_cuda",
                                    "long_context.yaml")


def phase_det_cli(workdir, greedy, card):
    """23b: the port's `det` on the card. `python -m
    determined_tpu_torch.cli preflight` of an examples/gpt2_cuda config
    must exit 0 and print the report the port's analysis gives in this
    process; `serve --local` of phase 5's serving config (its checkpoint)
    must answer phase 5's greedy request with phase 5's tokens through
    the decode graph, then drain on SIGTERM and exit 0."""
    import signal

    from determined_tpu_torch import analysis
    from determined_tpu_torch.cli import _load_config_file

    env = {k: v for k, v in os.environ.items()
           if k not in ("DET_MASTER", "DET_ALLOCATION_ID")}
    context = os.path.join(ROOT, "examples", "gpt2_cuda")
    t0 = time.monotonic()
    pre = subprocess.run(
        [sys.executable, "-m", "determined_tpu_torch.cli", "preflight",
         DET_PREFLIGHT_CONFIG, context], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    want = analysis.preflight(_load_config_file(
        os.path.join(ROOT, DET_PREFLIGHT_CONFIG)), context_dir=context)
    say(f"[23b] [{card}] det preflight {DET_PREFLIGHT_CONFIG}: exit "
        f"{pre.returncode} in {time.monotonic() - t0:.1f} s:\n"
        f"{pre.stdout.strip()}")
    if pre.returncode != 0 or pre.stdout.strip() != want.to_text().strip():
        say(pre.stderr[-3000:])
        fail("23b: det preflight did not exit 0 with the port's report")

    with open(os.path.join(workdir, "serve.json")) as f:
        config = json.load(f)
    port = free_port()
    config["serving"]["port"] = port
    path = os.path.join(workdir, "det_serve.json")
    with open(path, "w") as f:
        json.dump(config, f)
    log_path = os.path.join(workdir, "det_serve.log")
    url = f"http://127.0.0.1:{port}"
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "determined_tpu_torch.cli", "serve",
             "--local", path], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                break
            try:
                if _get(url + "/healthz", timeout=5)[0] == 200:
                    break
            except OSError:
                time.sleep(1.0)
            if time.monotonic() - t0 > 600:
                break
        up_s = time.monotonic() - t0
        if proc.poll() is not None:
            with open(log_path) as f:
                say(f.read()[-3000:])
            fail(f"23b: det serve --local exited {proc.returncode} before "
                 "serving")
        status, body = _post(url + "/v1/generate", {
            "tokens": greedy["prompt"],
            "max_new_tokens": len(greedy["tokens"]), "temperature": 0.0})
        stats = json.loads(_get(url + "/v1/stats")[1])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        log = f.read()
    same = status == 200 and body.get("tokens") == greedy["tokens"]
    engine = stats.get("engine", {})
    say(f"[23b] [{card}] det serve --local: up in {up_s:.1f} s; a greedy "
        f"request of {len(greedy['prompt'])} tokens: HTTP {status}, "
        f"{len(body.get('tokens', []))} tokens, equal to phase 5's "
        f"in-process replica: {same}; decode_steps "
        f"{engine.get('decode_steps')}, attention_launches "
        f"{engine.get('attention_launches')}; SIGTERM: exit {rc}, drained: "
        f"{'drain complete' in log}")
    if not same:
        fail(f"23b: det serve --local answered {status} {body}, phase 5's "
             f"replica {greedy['tokens']}")
    if not engine.get("attention_launches") or rc != 0 or \
            "drain complete" not in log:
        say(log[-3000:])
        fail("23b: det serve --local did not decode through the paged "
             "kernel's graph, or did not drain and exit 0 on SIGTERM")
    return {"up_s": up_s, "launches": engine["attention_launches"]}


PHASE_SECONDS = {}


def time_phases():
    """Wrap every `phase_*` function of this module to add its wall time
    to PHASE_SECONDS (a phase another phase calls counts in both)."""
    def timed(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                PHASE_SECONDS[fn.__name__] = PHASE_SECONDS.get(
                    fn.__name__, 0.0) + time.monotonic() - t0
        return run

    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = timed(fn)


def main() -> int:
    time_phases()
    card = phase_device()
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.monotonic()
    phase_build()
    paged_err = phase_kernel_check()
    flash_err = phase_flash_check()
    workdir = os.path.join(ROOT, "build", "smoke")
    os.makedirs(workdir, exist_ok=True)
    ckpt = write_model(workdir)
    serve = phase_serve(workdir, ckpt, card)
    paged_ref = phase_graph_vs_eager(ckpt, card)
    phase_dense(ckpt, paged_ref, card)
    phase_parity(ckpt)
    hparams = train_hparams(workdir)
    train = phase_train(workdir, hparams)
    phase_restored_replica(train["ckpt_dir"], card)
    managed_launches = phase_managed_trial(workdir, hparams, train, card)
    pairs = phase_prefetch_pairs(workdir, hparams, card)
    multi = phase_multi_step(hparams, card)
    phase_remat_policies(card)
    launched = phase_launched_trial(workdir, hparams, card, train)
    phase_train_parity()
    paged = phase_paged_times(card)
    flash = phase_flash_times(card)
    moe = phase_moe_train(workdir, hparams, card)
    moe_multi = phase_moe_multi_step(hparams, card)
    moe_serve = phase_moe_serve(workdir, moe, card)
    phase_moe_parity()
    long = phase_long_context_train(workdir, hparams, card)
    ring = phase_ring_blocks(card)
    phase_ulysses_inner(card)
    phase_split_world(workdir, hparams, card)
    other = phase_other_models(workdir, card)
    trials = phase_torch_trials(workdir, hparams, card, train["step_ms"])
    pre = phase_preflight(hparams, long, other["13b"], card)
    pipe = phase_pipeline_walk(card)
    phase_pipeline_world(workdir, hparams, card)
    phase_moe_chunks(card)
    phase_moe_split_world(workdir, hparams, card)
    elastic = phase_elastic_restore(workdir, hparams, card,
                                    trials["14c"]["shared_fs"]["restore_ms"])
    phase_elastic_world(workdir, hparams, card)
    conv_split = phase_conv_split(card)
    phase_conv_split_world(workdir, card)
    farm = phase_farm(workdir, hparams, ckpt, card, launched)
    phase_capture_collectives(card)
    mesh = phase_multi_mesh(workdir, hparams, card)
    fit21 = phase_fit_captured(workdir, hparams, card)
    eval22 = phase_eval_captured(workdir, hparams, card)
    fit_mesh = phase_fit_mesh(workdir, hparams, card)
    phase_elastic_world(workdir, hparams, card, world=2, tag="22c")
    autotune = phase_autotune(workdir, hparams, card)
    det = phase_det_cli(workdir, serve["greedy"], card)
    graph = serve["runs"]["graph"]
    say(f"[times] [{card}] serving: compile() prepared the sampler in "
        f"{serve['compile_stats']['sample_s']} s; the first graph burst "
        f"ran {graph[0]['tokens_per_s']:.1f} tokens/s, the second "
        f"{graph[1]['tokens_per_s']:.1f}: the second "
        f"{graph[1]['tokens_per_s'] / graph[0]['tokens_per_s']:.2f}x the "
        f"first")
    say(f"[times] [{card}] managed trial: flash launches {managed_launches}; "
        f"checkpoint of the train state: synchronous {pairs['sync_ms']:.1f} "
        f"ms, async {pairs['async_ms']:.1f} ms blocking the loop")
    for mode in ("graph", "eager"):
        r = serve["runs"][mode][0]
        say(f"[times] [{card}] serving GPT-2 small bf16, 8 slots, {mode} "
            f"(first {mode} burst): decode step p50 "
            f"{r['decode_step_ms']:.3f} ms over {r['decode_steps']} steps, "
            f"{r['tokens_per_s']:.1f} tokens/s ({r['tokens']} tokens in "
            f"{r['wall_s']:.2f} s), TTFT p50 {r['ttft_p50_ms']:.1f} ms; one "
            f"step at 8 slots, position 320: host p50 "
            f"{serve['steps'][mode]['host_p50_ms']:.3f} ms, device "
            f"{serve['steps'][mode]['device_ms']:.3f} ms")
    say(f"[times] [{card}] training GPT-2 small bf16, B 8, S 1024, through "
        f"Trainer.fit: step {train['step_ms']:.2f} ms (mean over "
        f"{train['steps']} steps after the first report window), "
        f"{train['tokens_per_s']:.0f} tokens/s, MFU "
        f"{train['mfu'] * 100:.2f}% of 989 TFLOP/s, device idle share "
        f"{train['idle_share'] * 100:.1f}%")
    host = {k: " / ".join(f"{x:.2f}" for x in v)
            for k, v in multi["host"].items()}
    say(f"[times] [{card}] GPT-2 small bf16, B 8, S 1024, 4 steps a window "
        f"(8a, in turns): replayed host {host['replay']} ms a step, device "
        f"{multi['device']['replay']:.2f}; eager host {host['eager']} ms a "
        f"step, device {multi['device']['eager']:.2f}; bitwise equal: "
        f"{multi['bitwise']}")
    r, st = moe_serve["run"], moe_serve["steps"]["graph"]
    say(f"[times] [{card}] MoE GPT-2 small bf16 (8 experts, top-2), B 8, S "
        f"1024, through Trainer.fit: step {moe['step_ms']:.2f} ms, "
        f"{moe['tokens_per_s']:.0f} tokens/s, MFU {moe['mfu'] * 100:.2f}% "
        f"(active FLOPs), idle share {moe['idle_share'] * 100:.1f}%, peak "
        f"memory {moe['peak_gib']:.2f} GiB; make_multi_step bitwise "
        f"{moe_multi['bitwise']}; serving bf16, 8 slots: decode step p50 "
        f"{r['decode_step_ms']:.3f} ms, {r['tokens_per_s']:.1f} tokens/s, "
        f"TTFT p50 {r['ttft_p50_ms']:.1f} ms, a replayed step "
        f"{st['device_ms']:.3f} ms of device time in {st['kernels']:.0f} "
        f"kernels")
    say(f"[times] [{card}] long-context GPT-2 small bf16, B {LONG_BATCH}, S "
        f"{LONG_SEQ}, ring attention at context 1, through Trainer.fit: "
        f"step {long['step_ms']:.2f} ms, {long['tokens_per_s']:.0f} "
        f"tokens/s, MFU {long['mfu'] * 100:.2f}%, idle share "
        f"{long['idle_share'] * 100:.1f}%, peak memory "
        f"{long['peak_gib']:.2f} GiB; flash device ms a layer "
        + ", ".join(f"{k} {v:.3f}" for k, v in long["per_layer_ms"].items()))
    r50, prof = other["13b"], other["13b"]["profile"]
    say(f"[times] [{card}] ResNet-50 bf16, B {r50['batch']}, 224x224, "
        f"sgd(0.1, momentum=0.9): replayed step {r50['replay_ms']:.2f} ms "
        f"({r50['batch'] / r50['replay_ms'] * 1e3:.1f} samples/s), eager "
        f"{r50['eager_ms']:.2f} ms ({r50['batch'] / r50['eager_ms'] * 1e3:.1f}"
        f" samples/s); device ms a step: convolutions {prof['conv_ms']:.2f}, "
        f"BatchNorm {prof['bn_ms']:.2f}, other {prof['other_ms']:.2f}; idle "
        f"share {prof['idle_share'] * 100:.1f}%; peak {r50['peak_gib']:.2f} "
        f"GiB; replay bitwise {r50['bitwise']}")
    say(f"[times] [{card}] diffusion base bf16, B 64: fit's step "
        f"{other['13e']['step_ms']:.2f} ms; sample a denoising step: graph "
        f"{other['13e']['sample_ms']['graph']:.3f} ms, eager "
        f"{other['13e']['sample_ms']['eager']:.3f} ms")
    t14a, t14b, t14c = trials["14a"], trials["14b"], trials["14c"]
    say(f"[times] [{card}] GPT2TorchTrial (GPT-2 small bf16, B 8, S 1024) "
        f"through pytorch.Trainer.fit: step {t14a['step_ms']:.2f} ms, "
        f"{t14a['tokens_per_s']:.0f} tokens/s (phase 7's Trainer.fit "
        f"{train['step_ms']:.2f} ms); GPT2ZeroTrial on ZeroOneEngine (micro "
        f"batch 4 x 2): step {t14b['step_ms']:.2f} ms, "
        f"optimizer_state_numel {t14b['optimizer_state_numel']:,}")
    for name, r in t14c.items():
        say(f"[times] [{card}] checkpoint of GPT-2 small's TrainState to "
            f"{name}: save_state sync {r['sync_ms']:.1f} ms, wait "
            f"{r['wait_ms']:.1f} ms, "
            f"{r['bytes'] / 1e6 / ((r['sync_ms'] + r['wait_ms']) / 1e3):.1f}"
            f" MB/s; restore {r['restore_ms']:.1f} ms, "
            f"{r['bytes'] / 1e6 / (r['restore_ms'] / 1e3):.1f} MB/s")
    for name in ("12a", "13b"):
        g = pre[name]["gib"]
        say(f"[times] [{card}] preflight {name}: estimate total "
            f"{g['total']:.4f} GiB <= peak {pre[name]['peak_gib']:.4f} GiB <= "
            f"total + activations {g['total'] + g['activations']:.4f} GiB; "
            f"analysis {pre['wall_ms'][name]:.1f} ms of host time")
    say(f"[times] [{card}] GPT-2 small bf16, B {PIPE_BATCH}, S 1024, the "
        f"GPipe schedule walked over 2 stages in one process (M "
        f"{pipe['m']}): step {pipe['ms']['walked']:.2f} ms against the "
        f"plain step's {pipe['ms']['plain']:.2f} ms; device time "
        f"{pipe['device_ms']['walked']:.2f} against "
        f"{pipe['device_ms']['plain']:.2f} ms")
    h, t = fit21["host"], fit21["traced"]
    say(f"[times] [{card}] GPT-2 small bf16, B 8, S 1024, Trainer.fit's "
        f"step (21a, in turns): replayed host "
        f"{' / '.join(f'{x:.2f}' for x in h['captured'])} ms a step, traced "
        f"busy {t['captured']['busy_ms']:.2f} ms, idle "
        f"{t['captured']['idle'] * 100:.1f}%; eager host "
        f"{' / '.join(f'{x:.2f}' for x in h['eager'])} ms, traced busy "
        f"{t['eager']['busy_ms']:.2f} ms, idle "
        f"{t['eager']['idle'] * 100:.1f}%; peak GiB {fit21['peak_gib']}; "
        f"bitwise {fit21['bitwise']}")
    h, t = eval22["host"], eval22["traced"]
    say(f"[times] [{card}] GPT-2 small bf16, a validation pass of "
        f"{len(EVAL22_ROWS)} batches ({EVAL22_ROWS} rows, 22a, in turns): "
        f"captured host {' / '.join(f'{x:.2f}' for x in h['captured'])} ms, "
        f"traced busy {t['captured']['busy_ms']:.2f} ms; eager host "
        f"{' / '.join(f'{x:.2f}' for x in h['eager'])} ms, traced busy "
        f"{t['eager']['busy_ms']:.2f} ms; bitwise {eval22['bitwise']}")
    say(f"[times] [{card}] autotune of GPT-2 small bf16, S 1024, through "
        f"Trainer.fit's replayed step (23a): best global_batch_size "
        f"{autotune['best']}, {autotune['samples_per_second']:.2f} samples/s;"
        f" failed sizes {autotune['failed']}; {len(autotune['rows'])} trials "
        f"in {autotune['wall_s']:.1f} s")
    say("[times] seconds a phase: " + ", ".join(
        f"{k[len('phase_'):]} {v:.1f}" for k, v in sorted(
            PHASE_SECONDS.items(), key=lambda kv: -kv[1])))
    say(f"[done] all phases passed in {time.monotonic() - t_start:.1f} s")
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "kernel_route": "ffma",
        "source": "determined_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "determined_tpu/ops/paged_attention.py:99",
        "launches": serve["launches"],
        "launches_moe": moe_serve["launches"],
        "launches_warm_per_decode_step": farm["paged_per_step_warm"],
        "launches_det_serve": det["launches"],
        "max_abs_err": paged_err,
        **paged,
    }]
    for key, name, replaces in FLASH_KERNELS:
        kernels.append({
            "name": name,
            "route": "cuda",
            "kernel_route": train["routes"][key],
            "source": "determined_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": train["launches"][key],
            "launches_moe": moe["launches"][key],
            "launches_long": long["launches"][key],
            "launches_ring": ring[key],
            "launches_torch_trial": t14a["launches"][key],
            "launches_pipeline": pipe["launches"][key],
            "launches_elastic": elastic["launches"][key],
            "launches_warm": farm["launches_warm"][key],
            "launches_fit_traced": train["breakdown"]["flash"][name],
            "launches_fit21_traced": fit21["replayed_flash"][name],
            "launches_multi_mesh": None if mesh is None else
            mesh["fsdp"][0]["trace"]["replay"]["flash"][name],
            "launches_eval22_traced": eval22["replayed_flash"][name],
            "launches_autotune": autotune["launches"][key],
            "launches_fit_mesh_traced": None if fit_mesh is None else
            fit_mesh["fsdp"][0]["trace"]["captured"]["flash"][name],
            "long_ms": long["per_layer_ms"][key],
            "long_bound_ms": long["bound_ms"][key],
            "max_abs_err": flash_err[key],
            **flash[key],
        })
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
