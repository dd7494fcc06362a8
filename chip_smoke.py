#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: ``nvidia-smi`` name and power limit, torch, CUDA and nvcc versions,
   and which of the libraries that slice 16's trainers and shims wrap
   (TensorFlow, sklearn, joblib, dask, xgboost, LightGBM, transformers) are
   installed; none of them is on a card path. TF32 is switched off for the
   checks.
2. build: nvcc builds every kernel source of the ported paths
   (``ray_tpu_torch/ops/csrc/flash_fwd.cu`` and ``flash_bwd.cu``, both
   including ``mma_sm90.cuh``), all at once, on a thread of its own (the
   lane) while phases 28-31 and 24 run in this one; on the same lane
   phases 33 and 35 then run their clusters, neither of them this
   process's. Phases 28-31 and 24 launch none of the three kernels and
   hold their learners to bars, not times; but their learners run on the
   card, so the host-clock rates they print (env steps/s, rows/s) are
   taken while phase 33's job and phase 35's workflow train and serve
   GPT-2 on the same card. Their learners' update profiles are taken after
   the lane's end. Phase 32 and every phase after it wait for that end
   (``lane_wait`` in the ``seconds`` line), so the card is timed alone.
   It reports each kernel's
   registers and spills from ptxas (the tensor-core ``*_mma_kernel``
   instantiations for f16 and bf16, the CUDA-core ones for f32), and lists
   every instantiation that spills.
3. kernel vs plain: the ``flash_fwd`` sm_90a kernel against its plain
   PyTorch version (f32 math on the same rounded inputs) over dtypes
   {f32, bf16, f16} x head dims {16, 32, 64, 128} x B*H {12, 24} x causal
   x lengths, plus cross lengths, rows with no live column and ViT's
   non-causal lengths (197, 197) and (17, 17). Then the live length
   ``k_len`` on the device over a static cache of 544 rows (the Llama
   decode's): every dtype x D {64, 128} x Sq {1, 5} x k_len {1, 64, 513,
   543} x causal, with NaN in the rows past k_len, which the kernel must
   never read. Then the
   edges of the tensor-core design (bf16 and f16 run on it, f32 on the CUDA
   cores; the library reports which, and the phase asserts it): bf16 and
   f16 x D {16, 32, 64, 128} x causal Sq {65, 127, 1000} x Sk 1024, where
   the diagonal crosses a 64-row tile off its corner, and the training
   shape (B*H 192, S 1024, D 64, causal) in bf16, launched twice: the two
   launches must give the same bits. Tolerance, element by element,
   |err| <= atol + rtol * |ref| (``TOLS``): f32 1e-4, 1e-4 (sums in another
   order); bf16 1e-3, 1.6e-2 and f16 1e-3, 2e-3 (the kernel rounds each
   output once to 8 or 11 significant bits; rtol is 4x that rounding). lse
   atol 1e-3 and +inf on exactly the same rows, whose outputs must be 0.
4. bwd kernel vs plain: dq from ``flash_bwd_dq`` and dk, dv from
   ``flash_bwd_dkv`` against the plain blockwise backward, both given the
   same q, k, v, a non-uniform dO and the forward kernel's out and lse, over
   {f32, bf16, f16} x D {16, 32, 64, 128} x B*H 12 x causal x S {1, 64, 129,
   512, 1024}, plus (16, 64), (1, 300) and causal (64, 16), whose dead rows
   must get dq = 0 exactly, ViT's non-causal (197, 197) and (17, 17), and
   the training shape (B*H 192, S 1024, D 64,
   causal) in f32. Tolerance: ``TOLS``, element by element, per tensor. One
   bf16 case is also held against torch.autograd through
   ``attention_reference`` in f32, at atol 1e-2 (delta takes the forward's
   bf16-rounded output) and rtol 1.6e-2. Then the edges of the tensor-core
   design (bf16 and f16 run on it, f32 on the CUDA cores; the library
   reports which): bf16 and f16 x D {16, 32, 64, 128} x causal Sq {65, 127,
   1000} x Sk 1024, where the diagonal crosses a 64-row tile off its
   corner, and the training shape in bf16.
5. serve in f32: GPT-2-124M at full width with random weights decodes 3
   prompts x 16 tokens through the kernel and through its plain version
   on the same weights; the tokens must be equal. ``entry()`` runs its
   (2, 256) forward.
6. serve at bf16 (the serving path): ``LLMServer`` answers 4 concurrent
   requests (prompts of 32, 129, 300, 512 tokens) and then the 32-token
   prompt again, 16 tokens each. Launch counts are zeroed just before and
   read just after. Checks: 16 tokens per stream, the repeat streams the
   same tokens and hits the prefix cache, flash_fwd launches >= 12 x
   forwards and no backward launch, last-position logits within atol 5e-2
   of the plain version's. Prints TTFT and tokens/s.
7. train in f32: GPT-2-124M at full width, batch 2, seq 256,
   ``loss_chunks=8``: one ``build_train_step`` step through the kernels and
   one through the plain attention (autograd through the blockwise
   forward), from the same weights. Loss within 1e-5 relative; every
   parameter's gradient within 1e-4 relative norm (the worst and the median
   leaf are printed).
8. train at bf16 (the training path, ``bench.py``'s first flash
   configuration): GPT-2-124M, batch 16, seq 1024, ``loss_chunks=8``,
   AdamW, one fixed batch. Launch counts are zeroed, then 3 warm-up and 10
   timed steps run (``train_bf16`` in ``ray_tpu_torch/tools/train_runs.py``,
   which ``tools/fwd_ab.py`` times too). Checks: finite loss, lower at step
   13 than at step 1, and flash_fwd = flash_bwd_dq = flash_bwd_dkv = 12 x 13
   launches. Prints
   step ms, tokens/s, the losses and the peak memory.
9. llama_f32: Llama-2-7B width cut to 4 layers, f32, random weights from
   seed 0 drawn on the card: the prefill's last logits and 8
   teacher-forced decode steps (2 prompts of 128 tokens) through the f32
   kernel against the plain attention, max |d| / max |ref| <= 1e-3
   (``LLAMA_F32_LIMIT``), and the full causal pass's last logits against a
   step-by-step decode from empty caches at the same limit; flash_fwd
   launches 9 x 4.
10. llama_serve Llama-2-7B, 11. llama_serve Llama-3-8B (GQA, 8 KV heads):
   full depth and width, bf16 Dense and Embed weights, f32 norm scales.
   ``generate`` over 4 prompts of 512 random tokens, 32 greedy new tokens,
   caches of 544 handed whole to the kernel with the live length on the
   device, launch counts zeroed just before and read just after:
   flash_fwd exactly 32 per prefill + 32 per decode step x 31 = 1024, no
   backward launch; the tokens' sha256. Then its prefill and decode steps
   timed again (3 runs), and the prefill's last logits and every
   teacher-forced decode step against the plain attention on the same
   weights and tokens: ||d|| / ||ref|| <= 5e-2 and max |d| <= 0.25
   (``LLAMA_BF16_LIMITS``, argued before the first chip run; torch SDPA in
   the kernel's place, with the kernel's mask, is an ungated control).
   The kernel is also held on real activations: the q, k, v the model
   hands it at layers 0, 16 and 31 during the prefill and during one
   decode step, against its plain version at ``TOLS`` element by element.
   Prints prefill ms, decode ms per token, tokens/s, peak memory and the
   decode step's share of its HBM bound.
12. llama_train: Llama-2-7B width cut to 2 layers, bf16 compute over f32
   weights, batch 2 x 2048: one step's gradients through the kernels
   against the plain attention's (worst parameter's relative error norm
   <= 5e-2, ``LLAMA_GRAD_LIMIT``), then 5 AdamW steps on one batch: finite
   losses, the last below the first, and each kernel launched exactly 2
   x 5 times.
13. vit_train: ViT-B/16 at full depth and width (224^2, S 197, 86.6 M
   parameters), bf16 over f32 weights, batch 64, ``make_train_state``'s
   AdamW (lr ``VIT["lr"]``): 5 steps on one batch, finite losses, the last
   below the first, 12 launches of each kernel per step (non-causal,
   B*H 768, S 197, D 64); the kernel held on the real q, k, v of layers
   0, 6 and 11 at ``TOLS``; an f32 pass cut to 2 layers at full width,
   kernel path against plain path on the logits, max |d| / max |ref| <=
   1e-4 (``VIT_F32_LIMIT``). Prints step ms and images/s.
14. resnet_train: ResNet-50 with the CIFAR stem, bf16 over f32 weights,
   batch 256 of 32^2 images, AdamW (lr ``RESNET["lr"]``): 5 steps on one
   batch, finite losses, the last below the first, and no flash kernel
   launched (its convolutions are cuDNN's). Prints step ms and images/s.
17. moe_train (runs before 15): the Switch-MoE LM, ``MoELMConfig()`` at full
   width and depth (vocab 50257, 768 wide, 12 layers, 12 heads, 8 experts,
   an MoE FFN in every second block, capacity factor 1.25; 322.6 M
   parameters), bf16 over f32 weights with the MoE FFN in f32, batch 16 x
   1024, AdamW at the reference's lr 3e-4: 5 steps on one batch with launch
   counts zeroed just before the steps and read just after (12 of each
   kernel per step), finite losses, the last below the first, aux finite
   and above 0.1 at every step. Prints step ms, tokens/s, peak memory and
   each MoE block's share of dropped tokens. Then the yardstick: the
   reference's one-hot (T, E, C) dispatch in place of the index dispatch
   for 2 steps on the same weights and batch; its first loss within 1e-6
   relative of the index form's (the forward is the same to the bit), the
   same drop shares, its step ms and peak memory. Then the f32 check, cut
   to 2 layers at full width (one dense block, one MoE block), batch 2 x
   256: one step's loss and gradients through the
   kernels against the plain attention's at phase 7's limits, with 2
   launches of each kernel on the kernel path and none on the plain path.
15. kernels: per kernel its launches on its path, error, time (CUDA events)
   at that path's shape, the plain version's time, a PyTorch call as a
   yardstick (the port never calls it) and the least time the card could
   take: flash_fwd at GPT-2's serving shape (B*H 12, S 512, D 64, causal,
   bf16) and at Llama's prefill (B*H 128, Sq 512 over the cache of 544
   rows, k_len 512, D 128) and decode (B*H 128, Sq 1, cache 544, k_len
   543, D 128) shapes, and all three kernels at GPT-2's training shape
   (B*H 192, S 1024, D 64, causal, bf16), Llama's (B*H 64, S 2048, D 128)
   ViT-B/16's (B*H 768, S 197, D 64, non-causal), the MoE LM's (GPT-2's
   training shape, the MoE path's launches) and phase 36's gang's (a
   rank's half of GPT-2's batch: B*H 96, S 1024, D 64, causal), each held
   to the
   bf16 ``TOLS`` element by element
   (the line prints the tolerance and the largest error's share of its
   limit), with an estimate of attention's share of each training step.
   Each entry also gives its design as the library reports it
   ("mma.sync" or "cuda-core f32") and its rate in TFLOP/s (the live
   pairs' FLOPs over its time); the backward entries give dq + dk/dv over
   SDPA's backward. Beside SDPA's
   forward time the forward entries give which SDPA backend ran (from the
   profiler's op names), its kernels' device time, and SDPA's own output
   error as a share of the bf16 limit against the same plain reference; the
   backward entries name the backend of SDPA's backward. ``device_ms`` is
   the kernel's own time from the profiler (each of the three), the mean
   of the ``device_records`` it kept of 20 launches; ``ms``
   (CUDA events around many
   calls) also holds the host's work per call, the larger part at the
   serving shape. Two launches of each backward kernel at the training
   shape must give the same bits.

16. llama_trace: Llama-2-7B serving once more, after every events
   timing, under the profiler: one prefill and 4 decode steps, each
   call's device time (the sum of its kernels' durations, the matrix
   products' part, flash_fwd's part, the rest, the largest kernels)
   against phase 10's host clock of the same calls, and the device's idle
   share.
18. moe_trace: one bf16 step of phase 17's model and batch, last, under the
   profiler: the device's time by class (each flash kernel, matrix
   products, the rest) and by the host op that launched it (the expert
   products' ``bmm``, beside their least time at the f32 rate, the MoE
   dispatch and combine's index ops),
   the flash kernels' device ms per launch at B*H 192, S 1024, D 64 causal,
   and the idle share against phase 17's median host-clock step.
19. serve_run: the serving path through the port's runtime, last, so the
   replica's memory cannot disturb the other phases.
   ``ray_tpu_torch.init(num_cpus=4, num_gpus=1)`` starts the port's GCS and
   raylet (the raylet's ``nvidia-smi -L`` probe on), and the cluster must
   advertise GPU 1.0 with ``gpu-device-kind`` equal to ``nvidia-smi``'s
   name. ``serve.run`` deploys ``LLMServer`` (a subclass that adds one
   method, ``probe``, to read the replica's own launch counts) with phase
   6's arguments and weights and ``ray_actor_options={"num_gpus": 1}``: a
   replica actor in a worker process builds GPT-2-124M on the card.
   (a) Phase 6's prompts go over HTTP to ``serve.http_port()``, the four at
   once and then the 32-token one again, 16 tokens each, after one first
   request of another prompt (a cold replica's first forward, timed
   apart); the replica's counts are zeroed just before phase 6's prompts
   and read just after. Checks: 16 tokens per stream, equal to phase 6's
   streams; the repeat hits the prefix cache; the replica runs in another
   process than this one, on the card; flash_fwd launches = 12 x its
   forwards (one per layer) and no backward launch; its KV pool is
   arena-backed. (b) A GCS failover under the replica, in the same cluster
   (``tools/gcs_failover.py``): a KV key put, the replica's actor handle,
   pid and card memory taken, one HTTP request, then the GCS SIGKILLed
   (``global_worker.node.kill_gcs()``; its pid must be gone). During the
   outage one HTTP request must be answered with status 500 within
   ``gcs_failover.HTTP_DEADLINE_S`` (the proxy looks the replica up by name
   in the GCS, as the reference's does: the same outcome as the
   reference's proxy in ``tests/test_torch_gcs_ft.py``), and phase 6's
   32-token prompt, sent through the actor handle taken before the kill on
   the calls the proxy makes (``handle_request``, then ``next_chunks``),
   must stream phase 6's tokens. After ``restart_gcs()``: the KV key reads
   back; the state API lists the replica ALIVE with no restart and it
   answers from the same pid; the card's memory in use (``nvidia-smi``,
   every process's) and the replica's own reserve grew by less than half
   a model's bf16 weights (``FAILOVER_MIB_GROWTH``); the cluster still
   advertises GPU 1.0; a second actor asking ``num_gpus=1`` stays pending
   for 3 s (the replayed GCS must not hand the card out twice) and is
   killed; the controller still lists the replica; phase 6's 4 prompts at
   once over HTTP stream phase 6's tokens, with the replica's counts
   zeroed just before: flash_fwd = 12 x its 64 forwards, no backward
   launch. After ``serve.shutdown()`` and ``ray_tpu_torch.shutdown()`` no
   process of this session is left (by its session dir, so another
   cluster on the host is not counted) and ``nvidia-smi`` lists no card
   memory of the replica's pid. Prints TTFT per request over HTTP,
   tokens/s, the first request's TTFT, the replica's start seconds
   (``serve.run`` until ready) and its ``__init__``'s part, and its launch
   counts; then, on the ``serve_run_gcs_failover`` line, kill → first
   token during the outage, restart → GCS answering and restart → replica
   listed ALIVE (s), and the card's MiB and the replica's before and
   after.
20. train_fit: GPT-2-124M trained through the port's Train runtime, in its
   own cluster (``ray_tpu_torch.init(num_cpus=4, num_gpus=1)``, shut down
   at the end). ``TorchTrainer(ScalingConfig(num_workers=1, use_gpu=True))``
   with ``TorchConfig()`` (NCCL) and ``FailureConfig(max_failures=1)`` runs
   phase 8's configuration, seed-0 weights and batch in a worker the
   raylet spawned: ``create_mesh``, DDP by ``shard_train_state``,
   ``build_train_step(mesh=...)``, 3 reported steps, a ``save_pytree``
   checkpoint directory at step 1 (``CheckpointConfig(num_to_keep=1)``);
   the worker SIGKILLs itself once at step 2, and generation 1 recovers
   from the step-1 checkpoint and takes step 2. Checks: the worker's
   backend is "nccl", its pid is not the driver's, its card is
   ``nvidia-smi``'s, each loss is within 1e-2 of phase 8's at that step
   and the recovered step's within 1e-3, generation 0 launched each kernel
   12 x 2 times and generation 1 12 x 1 with no call of their plain
   versions, one more ``train_restarts_total``, the killed pid no longer
   running. Then a second fit runs 2 steps with
   ``TorchConfig(ingraph_psum="quantized")`` (the int8 DDP hook over NCCL;
   loss within 5e-2), first running phase 36 (c)'s "nccl" ops in its
   worker. No process of the session is left after shutdown. Prints the
   worker's step ms (generation 0's step 1) beside phase 8's, tokens/s,
   ``init`` s, each gang's start s and process-group s, the first step's
   s, each checkpoint's write s and size, ``train_recovery_seconds`` and
   the worker's peak memory. (Generation 0 of the recovered run stands in
   for an uninterrupted fit, which the script's time no longer holds.)
21. tune_asha_vit: Tune over the Train runtime, in its own cluster
   (``ray_tpu_torch.init(num_cpus=4, num_gpus=1)``, shut down at the end).
   ``tools/tune_runs.asha_tuner`` builds
   ``Tuner(TorchTrainer(tune_runs.vit_trial_loop, ScalingConfig(
   num_workers=1, resources_per_worker={"CPU": 1, "GPU": 0.25})))`` over a
   grid of 5 learning rates with ASHA (``max_t`` 8, ``grace_period`` 2,
   ``reduction_factor`` 2) and ``max_concurrent_trials=4``: each trial
   trains phase 13's model, weights and batch at its lr in a worker of its
   own on the card (an NCCL group of one on ``cuda:0``), four at a time
   (the fifth, 1e-8, once one of the first four ends), one report per
   step; each worker zeroes its launch counts before its first step.
   Checks: 5 trials, no error; each trial's launches exactly 12
   x its iterations of each kernel, no plain-version call, no kernel build
   in the worker (phase 2 built them); finite losses; the lr 1e-4 trial's
   first 5 losses within 1e-2 of phase 13's (the line says whether they
   are equal to the bit); ASHA stops at least one trial before ``max_t``,
   the fifth at ``grace_period`` among them, and a fresh ``ASHAScheduler`` replayed on the results in their order of
   arrival decides the same; ``get_best_result()`` names the trial with
   the lowest last loss; 4 trials ran at once (their loops' spans); no
   process of the session is left after shutdown. Prints the Tuner's wall
   s, per trial its lr, iterations, stop rung, worker start to loop s (the
   spawn, torch's import, the NCCL process group), the loop's CUDA
   context, model build and batch s, first-step s, median
   step ms of steps 2-n under sharing beside phase 13's, peak memory and
   kernel builds, and ASHA's record (rung, lr, loss, cutoff, decision).

22. data_resnet_fit: "TorchTrainer: ResNet-50 on CIFAR-10" through the
   port's Data, in its own cluster (``ray_tpu_torch.init(num_cpus=4,
   num_gpus=1)``, shut down at the end). The driver puts two datasets in
   the object store as blocks (``data.from_blocks``, no task): "parity",
   phase 14's batch as host arrays (numpy seed 50, 256 images of 32^2 and
   int64 labels, one block), and "train", 50,000 CIFAR-sized images in 10
   classes from numpy seed 51 in 50 blocks of 1,000 rows (614.4 MB).
   ``TorchTrainer(tools/data_runs.resnet_data_loop, ScalingConfig(
   num_workers=1, use_gpu=True), datasets=...)`` runs phase 14's model,
   weights and AdamW in a worker on the card; it takes 5 epochs of
   "parity" and one of "train" through ``get_dataset_shard(name).
   iter_torch_batches(batch_size=256, device=f"cuda:{local_rank}",
   drop_last=True)``. Checks: the 5 parity losses within 1e-2 of phase
   14's (the line says whether they are equal to the bit), the epoch saw
   195 x 256 rows in 195 steps, every loss finite, no flash kernel
   launched and no plain call, the worker on ``nvidia-smi``'s card, no
   process of the session left after shutdown. Prints the epoch's
   images/s beside phase 14's, the wait for the first batch, the put and
   fit seconds and the worker's peak memory.
23. batch_predict_vit: ``BatchPredictor.from_checkpoint(TorchPredictor.
   pack(ViT-B/16), ProbedTorchPredictor).predict(ds, batch_size=64,
   concurrency=2, num_cpus=1)``, in its own cluster: phase 13's model and
   seed-0 weights score 1,024 images of 224^2 (numpy seed 60, 616.6 MB,
   16 blocks of 64, with an ``id`` column) in two ``map_batches`` actors
   on the card (they lease CPUs only; the raylet leaves the card visible).
   ``ProbedTorchPredictor`` (defined here) hands back each row's ``id``
   and each actor's launch counts. Checks: every id once with 1,000
   logits; the logits against the driver's own forward of the same model,
   weights and images in the same batches of 64 at the bf16 ``TOLS``
   element by element, the argmax equal on every row (the line says
   whether they are equal to the bit); ``flash_fwd`` launched 12 x 16 =
   192 times in the actors, no backward launch and no plain call; two
   actors, neither the driver, on the card; no process left. Prints
   images/s of the whole ``predict`` and between the first and last
   scored blocks, each actor's start and load seconds and peak memory, and
   the driver's in-process images/s for the same forward.
24. rllib_ppo (runs after phase 31, before any profiler session): the
   tuned example ``cartpole-ppo`` as the repo ships it, built by
   ``run_regression.build_algorithm``: PPO, 2 env runners on CPUs,
   fragments of 256, lr 5e-3, 6 epochs x minibatch 128, seed 0, the
   learner in the driver on the card. ``train()`` until
   ``episode_return_mean`` reaches the yaml's bar (100) or its budget (30
   iterations). Checks: the bar is reached; the learner's parameters and
   Adam state on the card; the driver has the card open (its
   ``/dev/nvidia*`` files) and no session process does (the runners see no
   card); no flash kernel launched; the timesteps equal the
   rows sampled; one ``PPOLearner.update`` of the trained weights on one
   batch (512 rows from numpy seed 70; 24 Adam steps) on the card and on
   the CPU, TF32 off, agree in metrics and weights at rtol 1e-5, atol
   1e-6; no process left. Prints iterations to the bar, env steps/s, each
   iteration's host seconds of sampling and of ``learner.update``, one
   update's ms by CUDA events, its kernels' busy ms, launches and idle
   share (the profiler, on the last iteration's batch), and the learner's
   peak card memory.
25. rllib_impala_group (after phase 24): the tuned example
   ``cartpole-impala-multilearner``: IMPALA, 2 env runners on CPUs,
   fragments of 256, seed 0, 2 learner actors at ``num_gpus_per_learner``
   0.5 sharing the card, their gradients mean-allreduced as one flat
   vector over the "store" collective; until the yaml's bar (60) or budget
   (40 iterations). Checks: the bar is reached; both learners on the card
   and with it open, no other session process; the two ranks'
   weights equal at rtol 1e-5, atol 1e-6 after the last iteration (the line
   says whether to the bit); the timesteps equal the rows sampled; no
   process left; v-trace on a fragment of 256 (numpy seed 71) on the card
   against the CPU at rtol 1e-4, atol 1e-4. Prints iterations to the bar,
   each iteration's seconds of sampling and of the group's updates, each
   rank's update and allreduce seconds, and v-trace's ms, busy ms and
   launches on the card beside its CPU ms.

26. ring_attention (runs after phase 17, before 15): ring attention at
   GPT-2's training shape, bf16, B 16, H 12, S 1024, D 64 from numpy seed
   26, the sequence in 4 chunks of 256, its 4 ranks played in turn in one
   process by ``tools/ring_runs.py`` through ``ops.ring_attention``'s own
   per-rank loop (``ring_forward``, ``ring_backward``), forward and
   backward, causal and not: launch counts zeroed just before and read
   just after each run, and read around each block for its kind (the
   diagonal or a whole block). Checks: out, dq, dk and dv against
   ``flash_attention_fwd``/``_bwd`` on the whole sequence, element by
   element at the bf16 ``TOLS`` with their rtol taken of |flash| + the
   ring's partial magnitudes (``ring_attention.TOL_REASON``: each block
   rounds its partial, flash its sum once), the grads both against
   flash's backward fed the ring's output and against flash's from its
   own output, where dq's and dk's limits gain what the forward's limit
   carries through delta (``ring_runs.delta_terms``); the line also gives
   each tensor's share of the plain ``TOLS``; the same in f32 against the
   plain ring (the kernels' plain versions on the card) at the f32
   ``TOLS``; launches 10 of each kernel causal and 16 non-causal, the
   block readings summing to them. Prints the ring's ms by CUDA events
   beside ``flash_attention``'s forward and backward on the whole
   sequence.
27. parallel_train (runs last: it forms and destroys an NCCL group in
   this process, after every phase that times or traces a kernel): in a process group of this process alone over NCCL, on meshes
   of size-1 axes: ``build_train_step_sp`` with ``attention="ring"`` at
   {"data": 1, "sp": 1}, ``build_train_step_pp`` at {"data": 1,
   "pipeline": 1} with 4 microbatches and ``shard_train_state_tp`` at
   {"data": 1, "model": 1} (its row products through the row path, which
   over a group of one is the plain product), each 5 steps of phase 8's
   configuration, seed-0 weights and batch; ``shard_train_state_ep`` at
   {"data": 1, "ep": 1}, 5 steps of phase 17's; Llama-2-7B through
   ``shard_params_tp``/``apply_tp_plan`` and ``generate`` (its caches
   split by ``shard_kv_caches_tp``) at {"model": 1} on phase 10's weights
   and prompts, its prefill and decode steps then run again on the tokens
   (``llama_runs.time_steps``) with the launches read around each. Checks:
   the backend is NCCL; every GPT-2 loss within 1e-2 of phase 8's and the
   MoE LM's of phase 17's, step for step; Llama's tokens equal to phase
   10's; launches per step 12 of each kernel for SP, TP and EP and 48 for
   PP, and 1,024 ``flash_fwd`` and no backward for Llama, 32 in the
   prefill and 992 in the decode steps. Prints each step's ms beside phase
   8's and phase 17's.

28-32. The second RLlib slice (28-31 run right after phase 1, beside
   the lane, then phase 24; phase 32 after the lane's end, before 25;
   each learner in the driver on the card, ``num_gpus_per_learner`` 1, the
   default; each update's profile (ms by CUDA events, the kernels' busy ms,
   launches and idle share) is taken after phase 25, in one
   ``rllib_update_profiles`` line). Each phase checks: the learner's
   parameters and optimizer moments on the card; the driver has the card
   open and no session process does; no session process left after
   shutdown; the learner's next update, from its trained weights, Adam
   state (and target) on one batch, on the card and on the CPU, TF32 off,
   agree in metrics and weights at rtol 1e-5, atol 1e-6 (DT: see 32); no
   flash kernel launched but by DT. Each prints iterations to the bar, env
   steps/s (offline: dataset rows consumed a second) and its host split.
28. rllib_offline: ``run_regression.offline_dataset("cartpole_expert")``
   once (PPO, 8 iterations with its learner on the card, then 2 x 512
   steps from its CPU runner); then ``cartpole-marwil`` and
   ``cartpole-cql`` built by ``run_regression.build_algorithm``, and BC as
   ``test_bc_clones_expert`` runs it (20 epochs x minibatch 256, lr 3e-3),
   each ``train()`` followed by a greedy ``evaluate()`` on the one CPU
   runner until the evaluation return reaches the bar (60; BC 50) within
   the budget (30, 40; BC 1 iteration).
29. rllib_qmix: ``twostep-qmix`` (one CPU runner, fragments of 64, seed
   3) until the training return reaches 7.5 within 60 iterations; the
   timesteps equal 64 a iteration.
30. rllib_r2d2: ``memorychain-r2d2`` (one CPU runner, 32 episodes of 4
   steps an iteration, seed 0) until the training return reaches 0.9
   within 40 iterations; the timesteps equal 128 an iteration.
31. rllib_dreamerv3: ``test_dreamerv3_learns_cartpole``'s contract:
   ``DreamerV3Config()`` on CartPole, seed 0, 35 iterations (200 env
   steps from the one collector in the driver, 8 updates of batch 8 x 32,
   horizon 15): the best training return above 40, the state round trip
   equal to the bit and a 2-episode greedy evaluation. The CPU update
   replays the card's latent and action draws. (The yaml's full bar, 100
   in 130 iterations, is ``python -m ray_tpu_torch.rllib.run_regression
   --select cartpole-dreamerv3``, run apart.)
32. rllib_dt: ``cartpole-dt`` on phase 28's file (context 8, minibatch
   128, 25 updates an iteration, seed 0) until the return-conditioned
   greedy evaluation reaches 60 within 12 iterations; attention through the
   three f32 flash kernels at D 32, S 24 (B*H 256 a minibatch, 2 an
   action). Launch counts read around training and evaluation apart, and
   around one update (2 of each kernel) and one action (2 ``flash_fwd``).
   The q, k, v and dO DT hands the kernels in one update (and q, k, v of
   one action) go through the kernels again against their plain versions
   at the f32 ``TOLS``, element by element. Its CUDA-vs-CPU update holds
   the kernel path against the plain path, so its limit is the f32
   ``TOLS``; the key biases are held apart at 2 x lr (softmax does not see
   them; their gradients are rounding noise that Adam scales to steps of
   up to lr). Its ``kernels`` rows (``dt_train``, ``dt_act``) come last in
   that line: ms by events (taken here, before any profiler session), the
   plain versions' ms, SDPA's f32 forward and backward at the same shape
   as a yardstick, the bound against the f32 CUDA-core peak (67 TFLOP/s)
   and HBM, the errors from the real activations, and device ms.

33. cluster_cli (its run on the lane once the kernels are built, beside
   phases 28-31: no cluster of this process takes part, and its seconds
   and its job's step ms are taken beside those phases; its checks after
   phase 23, against phase 8):
   the port run as a cluster through the
   commands a user types (``tools/cluster_runs.drive``), each a subprocess
   of ``python -m ray_tpu_torch`` under a temporary ``HOME``: ``up`` of a
   YAML whose head has 4 CPUs and ``GPU: 0`` and whose one worker node type
   ``gpu_node`` ({"GPU": 1, "CPU": 4}, ``min_workers`` 0, ``max_workers``
   1, 6 s idle timeout) the autoscaler monitor launches through
   ``FakeGpuNodeProvider``; ``status``; ``submit`` of ``python -m
   ray_tpu_torch.tools.cluster_runs job``, whose driver (on the head, never
   touching CUDA) fits ``TorchTrainer(ScalingConfig(num_workers=1,
   use_gpu=True))`` over NCCL: phase 8's configuration, seed-0 weights,
   batch and bf16 for 4 steps, its mesh ``create_hybrid_mesh({"fsdp": 1},
   {"data": 1})`` and its state ``shard_train_state(fsdp=True)``; then
   ``job logs``, the idle node's teardown, ``microbenchmark --small``
   against the head (its rows printed) and ``down``. Checks: ``status``
   shows one node and no GPU; the gang's placement group made the monitor
   launch ``gpu_node`` and the worker trained there (its node id the
   launched node's, not the head's); the job SUCCEEDED and its logs carry
   each loss; the worker's launch counts, read in the worker, are 12 a step
   of each kernel with no plain-version call; the losses within 1e-2 of
   phase 8's first 4 (the line says whether they are equal to the bit);
   the idle node is torn down; ``down`` leaves no process of the session.
   Prints ``up`` s, submit to the node's registration s, gang start s, the
   worker's step ms beside phase 8's, job wall s and teardown s.
34. serve_autoscale (after phase 33): phase 19's app (GPT-2-124M's
   ``LLMServer`` deployment, bf16, phase 6's weights) in its own cluster
   with ``autoscaling_config`` 1 to 2 replicas, ``target_ongoing_requests``
   2 and ``ray_actor_options={"num_gpus": 0.5}``, driven by
   ``serve.load_harness.run_load`` through the proxy: 8 connections, phase
   6's 4 prompts (32-512 tokens, 16 new each) in turn at 8 requests a
   second for 10 s, then windows of 5 s until both replicas have served.
   Checks: ``running_replicas`` 1 before the load and 2 after; both
   replicas (separate processes on the card) launched ``flash_fwd``,
   exactly 12 per forward and no backward, read from each replica's actor;
   every answer 200 and equal to phase 6's in-process greedy tokens for
   its prompt; no process left. Prints ``run_load``'s TTFT and latency
   percentiles, tokens/s, the time to scale up and each replica's
   launches.
35. workflow_queue (its run on the lane after phase 33's, in a process
   of its own, ``workflow_runs.drive_checked``; its in-process decode and
   checks after phase 34; its seconds are taken beside phases 28-31 and
   24; ``tools/workflow_runs.py``): in its own
   cluster (4 CPUs, 1 GPU), the durable workflow
   ``serve_step.bind(train_step.bind(...), wait_for_event(FileListener,
   path))``, both steps ``num_gpus=0.5``. ``train_step`` trains GPT-2-124M
   as phase 8 does (bf16 over f32, 16 x 1024, seeds 0 and 1) for 4 steps
   and saves the weights under the workflow's storage; ``serve_step``
   loads them and answers phase 6's 4 prompts, 16 greedy tokens each,
   through ``GPT2LLM``. The first run is a driver subprocess, SIGKILLed
   once the train step's checkpoint is in storage while the event step
   waits; the event's file is then created and ``workflow.resume`` runs
   from this process. Then ``util.multiprocessing.Pool(2).map`` builds
   phase 6's prompts on CPU workers, the driver puts them into a
   ``util.queue.Queue(maxsize=2)`` (a third put without blocking is
   refused) and a ``num_gpus=0.5`` consumer actor answers each onto a
   second queue; the consumer is created before the workflow's first run,
   so that its start (a process, GPT-2 built on the card) runs under the
   workflow. Checks: the killed run did not read
   SUCCESSFUL; the train step
   ran once (a call log); its losses equal phase 8's first 4 to the bit;
   it launched each kernel 4 x 12 times in its worker; the resumed run's
   serve step launched ``flash_fwd`` >= 12 per forward and no backward
   kernel; its tokens (and ``get_output``'s) equal a greedy decode of the
   saved weights in this process; ``get_status`` reads SUCCESSFUL and
   ``list_all`` names the run; the pool's prompts and the consumer's
   tokens equal phase 6's, with ``flash_fwd`` >= 12 per forward and no
   backward launch in the consumer; every step and the consumer ran on the
   card in a process of its own; no process of the session is left.
   Prints each step's seconds, kill to resume, the resumed run's seconds,
   the consumer's start (its creation to its model on the card) and how
   long the queue waited for it, the queue's round trip per prompt and the
   launches.
36. gang_data_plane (after phase 35; ``GANG``): in its own cluster (4
   CPUs, 1 GPU). (a) Objects: a writer actor at ``num_gpus=0.5`` builds
   GPT-2-124M's parameters on the card from phase 8's seed (124.4 M f32,
   497.8 MB) and puts them twice, as a dict of CUDA tensors and as numpy;
   a second card actor, the driver and an actor at ``num_gpus=0`` with
   ``CUDA_VISIBLE_DEVICES=""`` read both, the three at once. Checks: every read equal to the
   bit (sha256 over names, dtypes, shapes and bytes); tensors rebuilt on
   the card by the card readers and on the CPU by the hidden one; numpy
   reads zero-copy (read-only); torch's own pickle of a CUDA tensor raises
   in the hidden reader (why ``_private/serialization.py`` carries CUDA
   tensors as host bytes); ``object_summary`` lists both objects with this
   file as their call site; the store drops both once the refs are gone.
   (b) GradSync: ``TorchTrainer`` with two workers at ``{"GPU": 0.5}``,
   ``TorchConfig(backend="gloo")`` and ``overlap_grads=True`` runs
   ``tools/gang_runs.gradsync_loop``: phase 8's model, weights and AdamW,
   each rank its half (8 x 1024) of phase 8's batch, 2 steps, every
   gradient submitted to ``GradSync`` from a post-accumulate hook, mean-
   reduced over the store collective's ``train_dp`` group at the default
   ``collective_chunk_bytes`` and copied back to the card; then the same
   for 2 steps with ``collective_quant="int8"``. Checks: the ranks' mean
   f32 losses within 1e-2 of phase 8's first 2, the int8 ones within 5e-2
   of its first 2; rank 0's f32-reduced step-1 gradient within
   ``GANG["grad_limit"]`` of the whole batch's taken in the driver, per
   parameter, where twice it (a sum) and rank 0's own (no reduction) are
   not, and within ``GANG["halves_limit"]`` of the mean of each rank's
   gradient taken in the driver; step 1's int8-reduced gradients within
   the reference's analytic bound of the f32-reduced ones, per parameter;
   ``steptrace_summary`` has ``train_dp`` rows with chunk records and no
   missing rank, and a collective interval overlapping its rank's
   ``compute`` phase, in each fit; the int8 wire below its logical bytes;
   ``train_timeline`` writes a trace with both ranks; each worker launched
   each kernel 12 x steps times. (c) The "nccl"
   backend: phase 20's quantized fit (an NCCL gang of one) runs
   ``allreduce``, ``allgather``, ``reducescatter`` and ``broadcast`` of
   CUDA tensors through ``init_collective_group(..., backend="nccl")``:
   each result on the card (allreduce and broadcast in place) and equal to
   the store backend's on the same inputs. Prints the put and get seconds
   and GB/s of each form per reader, step ms, allreduce and exposed
   seconds per step, wire and logical bytes of each fit, and the int8
   check's worst error over its bound and the gradient gaps' worst.
37. serve_multiplex_redeploy (in phase 19's cluster, after its (a) and
   (b); phase 19's app is deleted first, freeing the card's lease;
   ``tools/multiplex_runs.py``, which ``tests/test_torch_serve_multiplex.py``
   runs at small size on the CPU): a deployment's class lives in a module
   written to a temporary directory and reaches its replica only through
   ``ray_actor_options={"num_gpus": 0.5, "runtime_env": {"working_dir":
   d}}`` (this process never imports it; the deployment names the class).
   The class loads GPT-2-124M (phase 6's bf16 flash configuration) with
   ``@serve.multiplexed(max_num_models_per_replica=2)``, the model id as
   its weights' seed. Phase 6's five requests go over HTTP, one after
   another, to model ids 0, 1, 0, 2, 1, 16 tokens each. Checks: each
   answer equal to the bit to the tokens of a ``GPT2LLM`` of that seed run
   in this process on the card (for id 0, phase 6's in-process server's,
   whose model is seed 0; ids 1 and 2 decode on a thread while the
   replica starts);
   the replica loaded 0, 1, 2, 1 (4 loads, the last a reload of 1) and
   holds 1 and 2 after (2 evictions: 2 evicted 1, the reload of 1 evicted
   0); flash_fwd launches = 12 x the forwards it reports (80), no backward
   launch. Then ``serve.run`` of a second directory, whose module tags
   each answer ``v2``, under the same app name and route, while a client
   thread sends requests (phase 6's 32-token prompt to model 1, one token)
   over HTTP without pause, until the ``v1`` replica's process is gone and
   10 more answers came: every answer 200 with the in-process model's
   token, the tags switching from ``v1`` to ``v2`` once and never back.
   The two versions lease half the card each: a rolling update keeps the
   old replica serving until the new one is up, so both must fit on the
   one card at once. Prints the requests sent during the rollout and the
   seconds from ``serve.run`` to the first ``v2`` answer.
38. observe_dag_actor (in phase 19's cluster, after phase 37;
   ``tools/observe_runs.py``, which ``tests/test_torch_observe_gpt2.py``
   runs at small size on the CPU): one ``ObservedGPT2`` actor at
   ``num_gpus=0.5`` holds GPT-2-124M (phase 6's bf16 flash configuration,
   seed 0), records a ``util.metrics`` Counter of its tokens and a
   Histogram of each request's ms, and prints one line a request. Phase
   6's 4 prompts go through ``experimental_compile(actor.generate.bind(
   InputNode()))``, 16 greedy tokens each, one after another, while
   ``util.profiling.profile_cpu`` (200 Hz) and ``profile_memory`` sample
   the whole cluster for 3 s; then one direct ``actor.generate.remote``
   call under a driver span with ``tracing.enable()``; the dashboard runs
   in this process. Checks: every answer equal to phase 6's stream to the
   token; the actor's own counts 768 ``flash_fwd`` launches (64 forwards
   x 12 layers) and no backward; the merged CPU profile holds the actor's
   pid and a stack with its ``actor:<id>`` frame and a frame of the
   models (``models/gpt2.py``); the memory profile lists sites of the
   actor's process; ``/metrics`` shows the counter at the tokens the
   actor produced, the histogram's count at its requests and
   ``ray_tpu_resources_total{resource="GPU"}`` at 1; ``get_log`` by the
   actor's id returns exactly the lines it printed and by the traced
   call's task id exactly that call's line; the actor's span has the
   driver's span as its parent, came from the actor's pid, and both render
   in ``ray_tpu_torch.timeline()``; the dashboard lists the actor ALIVE
   and its cluster resources show the actor's half card held (the listing
   carries no resources, in the reference as in the port). Prints, on the
   host clock and not gated: a one-token call's round trip through the
   compiled DAG, ``dag.execute`` and a direct call (median of 5), prompt
   0's decode tokens/s without a sampler and inside a CPU profile, the
   actor's start-up s; and the sample count, the actor's share of it, the
   stacks through ``ops/attention.py`` and the top three memory sites.

Every phase raises on a failed check; no failure is caught.

The script's time (at most 850 s of command; PERF.md lists each phase's
seconds). What was cut, each check standing as before: the nvcc
build, then phases 33's and 35's runs, moved onto a lane beside phases
28-31 and 24 (their checks later, in this process); phase 20's
uninterrupted fit, whose losses generation 0 of the recovered run now
gives; phase 36's f32 fit from 3 steps to 2; phase 34's first load
window from 15 s to 10, with one more 5 s window allowed after it, so
that the load still reaches 45 s if the second replica is slow to serve;
one profiled update of each
learner instead of three; phase 35's leases to half a card, so that its
consumer starts under the workflow. Phase 19 lost nothing and gained (b).
Phases 37 and 38 run in phase 19's cluster, so they pay no cluster start
of their own; phase 37 decodes its reference tokens on a thread while its
replica starts; the ``seconds`` line counts both apart from phase 19.

The ``kernels`` line comes after phase 27: phase 15's entries (with the
ring's diagonal and whole blocks at B*H 192, S 256 with phase 26's
launches by block kind, and the pipelined step's microbatch at B*H 48, S
1024, each timed there, with phase 27's launches), phase 27's SP, TP, EP
and Llama TP paths (which carry the times of the shapes they run at),
then the ViT-in-a-trial path's rows (phase 15's times at ViT-B/16's shape
with the launches the trials' workers counted), the batch-prediction
path's ``flash_fwd`` row (the same times, with the launches the
predictor's actors counted), phase 32's DT rows, and the rows of phases
33-34: the training shape's with the cluster job's worker's launches
(``cluster_job_worker``) and the serving shape's ``flash_fwd`` with the
autoscaled replicas' (``serve_autoscaled_replicas``), and phase 35's: the
training shape's with the workflow's train step's launches
(``workflow_train_step``) and the serving shape's ``flash_fwd`` with the
serve step's (``workflow_serve_step``) and the queue consumer's
(``queue_consumer``), phase 37's serving-shape ``flash_fwd`` with the
multiplexed replica's (``serve_multiplex_replica``) and phase 38's with
the DAG-driven actor's (``observed_dag_actor``); phase 15 also times
the three kernels at the gang's
shape (B*H 96: 8 rows x 12 heads, S 1024, D 64, causal), whose row
(``gang_train``) takes the launches phase 36's workers counted. Then one
line with
each phase's seconds (the lane's as ``build``, ``cluster_cli_drive`` and
``workflow_queue_drive``, the wait for its end as ``lane_wait``) and
``main_s``, the seconds of ``main``. The last two lines are the
``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import copy
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, dense bf16 on the
# tensor cores, and f32 on the CUDA cores (the f32 flash kernels' design)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12

GPT2_124M = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                 n_head=12)
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the libraries the trainers and shims of slice 16 wrap; none is on a card
# path, phase 1 says which are installed
OPTIONAL_LIBRARIES = ("tensorflow", "sklearn", "joblib", "dask", "xgboost",
                      "lightgbm", "transformers")
SOURCE = {"flash_fwd": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
          "flash_bwd_dq": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
          "flash_bwd_dkv": "ray_tpu_torch/ops/csrc/flash_bwd.cu"}
REPLACES = {"flash_fwd": "ray_tpu/ops/attention.py:138",
            "flash_bwd_dq": "ray_tpu/ops/attention.py:194",
            "flash_bwd_dkv": "ray_tpu/ops/attention.py:233"}


def emit(phase: str, **fields):
    # one write a line: the build thread emits while a phase runs
    sys.stdout.write(json.dumps({"phase": phase, **fields}) + "\n")
    sys.stdout.flush()


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True
                          ).stdout.strip()


def phase_device():
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = _run([f"{CUDA_HOME}/bin/nvcc", "--version"]).splitlines()[-1]
    import importlib.util

    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc,
         installed={name: importlib.util.find_spec(name) is not None
                    for name in OPTIONAL_LIBRARIES})
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as attn

    # every kernel source of the ported paths, one nvcc each, all at once
    sources = [attn._SOURCE, attn._BWD_SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    wall = time.perf_counter() - t0
    attn._load_kernel()
    attn._load_bwd_kernel()
    ptxas = {src.name: _build.ptxas_summary(path)
             for (path, _), src in zip(built, sources)}
    spills = sorted(name for kernels in ptxas.values()
                    for name, summary in kernels.items()
                    if not summary.endswith(" 0 bytes spilled"))
    emit("build", wall_s=wall,
         seconds={src.name: s for (_, s), src in zip(built, sources)},
         ptxas=ptxas, spills=spills)


def _close(got, want, atol, rtol):
    """Element by element |got - want| <= atol + rtol * |want|; returns
    (ok, max abs error, largest error as a share of its element's limit).
    A NaN fails."""
    err = (got - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    return share <= 1.0, float(err.max()), share


# kernel vs plain (f32 math on the same rounded inputs), (atol, rtol) by
# dtype, element by element
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 1.6e-2),
        torch.float16: (1e-3, 2e-3)}
TOL_REASON = ("f32: sums in another order; bf16/f16: the kernel rounds each "
              "output once to 8 or 11 significant bits (relative error at "
              "most 2^-8 or 2^-11), rtol is 4x that, atol covers values "
              "near 0")


def _tol_fields(dtype):
    atol, rtol = TOLS[dtype]
    return {"atol": atol, "rtol": rtol}


def _check_flash(q, k, v, causal, k_len=None):
    """Kernel vs plain on one input; returns (ok, out_err, lse_err,
    out error's share of its limit). Rows with no live column must get
    lse = +inf and out = 0 exactly. With a live length ``k_len``, the rows
    of k and v past it may hold NaN: the kernel must not read them, and the
    plain version takes them as 0 (they are masked)."""
    from ray_tpu_torch.ops import attention as attn

    out, lse = attn.flash_attention_fwd(q, k, v, causal=causal, k_len=k_len)
    ref, ref_lse = attn._flash_plain(q.float(), k.float().nan_to_num(),
                                     v.float().nan_to_num(), causal=causal,
                                     sm_scale=q.shape[-1] ** -0.5,
                                     k_len=k_len)
    ok_out, out_err, share = _close(out.float(), ref, *TOLS[q.dtype])
    same_inf = bool(torch.equal(torch.isinf(lse), torch.isinf(ref_lse)))
    dead_zero = not bool((out[torch.isinf(ref_lse)] != 0).any())
    fin = torch.isfinite(ref_lse)
    lse_err = float((lse[fin] - ref_lse[fin]).abs().max()) if fin.any() \
        else 0.0
    return (ok_out and same_inf and dead_zero and lse_err <= 1e-3, out_err,
            lse_err, share)


def _flash_cases():
    """(Sq, Sk, causal): square lengths, cross lengths, causal (64, 16)
    whose rows 0..47 see no key, and ViT's non-causal lengths: 197 (196
    patches and the class token of ViT-B/16) and 17 (``small_test``)."""
    cases = [(s, s, causal) for s in (1, 64, 129, 512, 1024)
             for causal in (False, True)]
    for causal in (False, True):
        cases += [(16, 64, causal), (1, 300, causal)]
    return cases + [(64, 16, True), (197, 197, False), (17, 17, False)]


# the live lengths of a decode over a whole static cache: Llama's cache of
# 544 rows (4 x 512 prompts + 32 new tokens), queries of 1 and 5 tokens
K_LEN_CACHE, K_LEN_QUERIES, K_LENS = 544, (1, 5), (1, 64, 513, 543)


def phase_kernel_vs_plain():
    from ray_tpu_torch.ops import attention as attn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {}   # {group: {dtype: [out_err, lse_err, share]}}
    failures = []
    n = 0

    def case(group, dtype, bh, d, sq, sk, causal, k_len=None):
        nonlocal n
        mk = lambda s: torch.randn((bh, s, d), generator=gen,
                                   device=dev).to(dtype)
        q, k, v = mk(sq), mk(sk), mk(sk)
        live = None
        if k_len is not None:   # NaN past the live length: never read
            k[:, k_len:] = v[:, k_len:] = float("nan")
            live = torch.tensor(k_len, dtype=torch.int32, device=dev)
        ok, out_err, lse_err, share = _check_flash(q, k, v, causal, live)
        n += 1
        key = str(dtype).split(".")[-1]
        w = worst.setdefault(group, {}).setdefault(key, [0.0, 0.0, 0.0])
        worst[group][key] = [max(a, b) for a, b in
                             zip(w, (out_err, lse_err, share))]
        if not ok:
            failures.append(dict(dtype=key, d=d, bh=bh, sq=sq, sk=sk,
                                 causal=causal, k_len=k_len, out_err=out_err,
                                 lse_err=lse_err, share=share))

    for dtype in TOLS:
        for d in (16, 32, 64, 128):
            for bh in (12, 24):
                for sq, sk, causal in _flash_cases():
                    case("lengths", dtype, bh, d, sq, sk, causal)
    # a live length k_len on the device over a static cache (the Llama
    # decode's); with Sq 5 and k_len 1, rows 0..3 see no key
    for dtype in TOLS:
        for d in (64, 128):
            for sq in K_LEN_QUERIES:
                for k_len in K_LENS:
                    for causal in (False, True):
                        case("k_len", dtype, 12, d, sq, K_LEN_CACHE, causal,
                             k_len)
    # the tensor-core design's edges: causal cross lengths whose diagonal
    # crosses a 64-row tile off its corner, and the training shape in bf16
    for dtype in (torch.bfloat16, torch.float16):
        for d in (16, 32, 64, 128):
            for sq in (65, 127, 1000):
                case("tensor_core_edges", dtype, 12, d, sq, 1024, True)
    case("training_shape", torch.bfloat16, 192, 64, 1024, 1024, True)
    # no atomics, a fixed order of sums: a second launch gives the same bits
    q, k, v = (torch.randn((192, 1024, 64), generator=gen, device=dev
                           ).to(torch.bfloat16) for _ in range(3))
    first = attn.flash_attention_fwd(q, k, v, causal=True)
    again = attn.flash_attention_fwd(q, k, v, causal=True)
    same_bits = all(torch.equal(a, b) for a, b in zip(first, again))
    del q, k, v, first, again
    torch.cuda.synchronize()
    design = {str(dt).split(".")[-1]: attn.fwd_design(dt) for dt in TOLS}
    emit("kernel_vs_plain", kernel="flash_fwd", cases=n, design=design,
         max_err={group: {k: {"out": v[0], "lse": v[1],
                              "out_share_of_limit": v[2]}
                          for k, v in by_dtype.items()}
                  for group, by_dtype in worst.items()},
         same_bits_twice=same_bits,
         tolerance={"out": {str(dt).split(".")[-1]: _tol_fields(dt)
                            for dt in TOLS}, "reason": TOL_REASON,
                    "share": "largest |err| / (atol + rtol*|ref|), at most 1",
                    "lse": "atol 1e-3, +inf on exactly the same rows, "
                           "whose outputs are 0"},
         failures=failures[:10])
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"in {len(failures)} of {n} cases")
    if not same_bits:
        raise AssertionError("a second flash_fwd launch gave other bits")
    if design != {"float32": "cuda-core f32", "bfloat16": "mma.sync",
                  "float16": "mma.sync"}:
        raise AssertionError(f"forward design by dtype is {design}")


def _check_bwd(q, k, v, do, causal):
    """Backward kernels vs the plain backward (f32 math on the same rounded
    inputs, the same out and lse from the forward kernel), element by
    element at ``TOLS``; returns (ok, [dq, dk, dv max abs errors],
    [their largest shares of the limit], grads)."""
    from ray_tpu_torch.ops import attention as attn

    out, lse = attn.flash_attention_fwd(q, k, v, causal=causal)
    got = attn.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    ref = attn._flash_bwd_plain(*(t.float() for t in (q, k, v, out)), lse,
                                do.float(), causal=causal,
                                sm_scale=q.shape[-1] ** -0.5)
    held = [_close(g.float(), r, *TOLS[q.dtype]) for g, r in zip(got, ref)]
    return (all(h[0] for h in held), [h[1] for h in held],
            [h[2] for h in held], got)


def phase_bwd_kernel_vs_plain():
    from ray_tpu_torch.ops import attention as attn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    worst, failures, n = {}, [], 0

    def case(dtype, bh, d, sq, sk, causal):
        nonlocal n
        key = str(dtype).split(".")[-1]
        mk = lambda s: torch.randn((bh, s, d), generator=gen,
                                   device=dev).to(dtype)
        q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
        ok, errs, shares, got = _check_bwd(q, k, v, do, causal)
        if sq > sk and causal:  # dead rows: exactly 0, no NaN
            ok = ok and not bool(got[0][:, :sq - sk].any())
        n += 1
        w = worst.setdefault(key, [0.0] * 6)
        worst[key] = [max(a, b) for a, b in zip(w, errs + shares)]
        if not ok:
            failures.append(dict(dtype=key, bh=bh, d=d, sq=sq, sk=sk,
                                 causal=causal, errs=errs, shares=shares))

    for dtype in TOLS:
        for d in (16, 32, 64, 128):
            for sq, sk, causal in _flash_cases():
                case(dtype, 12, d, sq, sk, causal)
    # the training shape (B*H 192, S 1024, D 64, causal) in f32 as well
    case(torch.float32, 192, 64, 1024, 1024, True)
    # one bf16 case against autograd through the naive reference in f32.
    # Besides rounding, delta = rowsum(dO * O) takes O rounded to bf16 by
    # the forward, an error shared by a whole row of dS: atol 1e-2.
    autograd_tol = (1e-2, TOLS[torch.bfloat16][1])
    q, k, v, do = (torch.randn((12, 512, 64), generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(4))
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = attn.attention_reference(*leaves, causal=True)
    ref_grads = torch.autograd.grad(ref, leaves, do.float())
    out, lse = attn.flash_attention_fwd(q, k, v, causal=True)
    got = attn.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    vs_autograd = [_close(g.float(), r, *autograd_tol)
                   for g, r in zip(got, ref_grads)]
    autograd_ok = all(h[0] for h in vs_autograd)
    # the tensor-core design's edges: causal cross lengths whose diagonal
    # crosses a 64-row tile off its corner, and the training shape in bf16
    for dtype in (torch.bfloat16, torch.float16):
        for d in (16, 32, 64, 128):
            for sq in (65, 127, 1000):
                case(dtype, 12, d, sq, 1024, True)
    case(torch.bfloat16, 192, 64, 1024, 1024, True)
    torch.cuda.synchronize()
    design = {str(dt).split(".")[-1]: attn.bwd_design(dt) for dt in TOLS}
    names = ("dq", "dk", "dv", "dq_share", "dk_share", "dv_share")
    emit("bwd_kernel_vs_plain", kernels=["flash_bwd_dq", "flash_bwd_dkv"],
         cases=n, design=design,
         bh=[12, "192 (f32 and bf16, S 1024, D 64, causal)"],
         max_err={k: dict(zip(names, v)) for k, v in worst.items()},
         tolerance={**{str(dt).split(".")[-1]: _tol_fields(dt)
                       for dt in TOLS}, "reason": TOL_REASON,
                    "share": "largest |err| / (atol + rtol*|ref|), at most 1"},
         vs_autograd_reference={
             "case": "bf16, B*H 12, S 512, D 64, causal",
             "atol": autograd_tol[0], "rtol": autograd_tol[1],
             "errs": [h[1] for h in vs_autograd],
             "shares": [h[2] for h in vs_autograd], "ok": autograd_ok},
         failures=failures[:10])
    if failures or not autograd_ok:
        raise AssertionError(f"backward kernels disagree: {len(failures)} of "
                             f"{n} cases vs plain, autograd ok={autograd_ok}")
    if design != {"float32": "cuda-core f32", "bfloat16": "mma.sync",
                  "float16": "mma.sync"}:
        raise AssertionError(f"backward design by dtype is {design}")


def phase_serve_f32():
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.serve.llm.model import GPT2LLM
    from ray_tpu_torch.tools.train_runs import plain_attention

    llm = GPT2LLM(seed=0, attention="flash", dtype=torch.float32,
                  **GPT2_124M)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 50257, size=n).tolist() for n in (16, 64, 129)]

    def greedy(prompt):
        toks = list(prompt)
        for _ in range(16):
            toks.append(llm.forward_next(toks))
        return toks[len(prompt):]

    kernel_toks = [greedy(p) for p in prompts]
    with plain_attention():
        plain_toks = [greedy(p) for p in prompts]
    equal = kernel_toks == plain_toks
    del llm

    forward, (model, batch) = entry()
    logits = forward(model, batch)
    torch.cuda.synchronize()
    entry_ok = (tuple(logits.shape) == (2, 256, 50257)
                and bool(torch.isfinite(logits.float()).all()))
    del model, logits
    torch.cuda.empty_cache()
    emit("serve_f32", tokens_equal=equal, kernel_tokens=kernel_toks,
         plain_tokens=plain_toks, entry_forward_ok=entry_ok)
    if not equal:
        raise AssertionError("f32 greedy tokens differ between the flash "
                             "kernel and its plain version")
    if not entry_ok:
        raise AssertionError("entry() forward gave a wrong shape or "
                             "non-finite logits")


def phase6_prompts():
    """Phase 6's 4 prompts (32, 129, 300 and 512 tokens from seed 2), which
    phases 19, 34, 37 and 38 send again and hold to phase 6's streams."""
    rng = np.random.default_rng(2)
    return [rng.integers(0, 50257, size=n).tolist()
            for n in (32, 129, 300, 512)]


async def _serve_requests(server, prompts, repeat):
    """Concurrent requests, then ``repeat``; per-request tokens and
    timestamps (submit, first token, last token)."""

    async def one(p):
        t0 = time.perf_counter()
        toks, stamps = [], []
        async for line in server({"tokens": p, "max_tokens": 16}):
            toks.append(json.loads(line)["token"])
            stamps.append(time.perf_counter())
        return toks, t0, stamps

    first = await asyncio.gather(*(one(p) for p in prompts))
    second = await one(repeat)
    return list(first) + [second]


def phase_serve_bf16():
    from ray_tpu_torch.serve.llm.engine import LLMServer
    from ray_tpu_torch.tools.train_runs import plain_attention

    server = LLMServer(real_model=True, kv_dim=768, page_tokens=16,
                       max_pages=512, max_running=8, prefix_cache_pages=128,
                       model_kwargs=dict(attention="flash",
                                         dtype=torch.bfloat16, **GPT2_124M))
    llm = server.model
    prompts = phase6_prompts()

    _zero_launches()
    llm.forwards = 0
    t0 = time.perf_counter()
    results = asyncio.run(_serve_requests(server, prompts, prompts[0]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    forwards = llm.forwards
    info = server.debug_info()

    streams = [r[0] for r in results]
    ttft = [r[2][0] - r[1] for r in results]
    decode_rate = [(len(r[2]) - 1) / (r[2][-1] - r[2][0]) for r in results]
    total_tokens = sum(len(s) for s in streams)

    seq = prompts[0] + streams[0][:-1]  # the input of the last forward
    kernel_logits = llm.logits(seq)[-1].float()
    with plain_attention():
        plain_logits = llm.logits(seq)[-1].float()
    logit_err = float((kernel_logits - plain_logits).abs().max())
    # one full forward of the 512-token prompt, host clock to sync: the
    # unit of work a decode step repeats per running sequence
    forward_ms = []
    for _ in range(6):
        t1 = time.perf_counter()
        llm.logits(prompts[3])
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t1) * 1e3)
    server.close()

    emit("serve_bf16", prompt_lens=[len(p) for p in prompts] + [32],
         tokens=streams, ttft_s=ttft, decode_tokens_per_s=decode_rate,
         total_tokens=total_tokens, wall_s=wall,
         tokens_per_s=total_tokens / wall, forwards=forwards,
         launches=launches, hit_rate=info["hit_rate"],
         forward_512_ms=sorted(forward_ms[1:])[2],
         last_logits_max_abs_err=logit_err)
    problems = []
    if any(len(s) != 16 for s in streams):
        problems.append("a stream did not give 16 tokens")
    if streams[-1] != streams[0]:
        problems.append("the repeated prompt streamed other tokens")
    if not info["hit_rate"] > 0:
        problems.append("the repeated prompt missed the prefix cache")
    if forwards != 16 * len(streams):
        problems.append(f"{forwards} forwards for {len(streams)} x 16 tokens")
    if launches["flash_fwd"] < 12 * forwards or launches["flash_fwd"] == 0:
        problems.append(f"flash_fwd launched {launches['flash_fwd']} times "
                        f"for {forwards} forwards")
    if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        problems.append(f"serving launched backward kernels: {launches}")
    if not logit_err <= 5e-2:
        problems.append(f"last-position logits differ by {logit_err}")
    if problems:
        raise AssertionError("; ".join(problems))
    return launches, streams


def _loss_problems(losses):
    """A training run's loss checks: finite, and the last below the
    first."""
    problems = []
    if not all(math.isfinite(x) for x in losses):
        problems.append("non-finite loss")
    if not losses[-1] < losses[0]:
        problems.append(f"loss did not fall: {losses[0]} -> {losses[-1]}")
    return problems


def _zero_launches():
    from ray_tpu_torch.ops import attention as attn

    attn.zero_launches()


def _read_launches():
    from ray_tpu_torch.ops import attention as attn

    return attn.read_launches()


def _f32_kernel_vs_plain(step_grads, n_layer):
    """One f32 step's loss and gradients from the same weights through the
    kernels and through the plain attention (``step_grads()`` -> (loss,
    grads)): (fields, problems) at phase 7's limits, loss 1e-5 relative and
    each gradient 1e-4 relative norm, with ``n_layer`` launches of each
    kernel on the kernel path and none on the plain path."""
    from ray_tpu_torch.tools import train_runs

    runs = {}
    for path, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", train_runs.plain_attention)):
        _zero_launches()
        with ctx():
            loss, grads = step_grads()
        runs[path] = (loss, _read_launches(), grads)
    (kloss, klaunch, kgrads), (ploss, plaunch, pgrads) = \
        runs["kernel"], runs["plain"]
    loss_rel = abs(kloss - ploss) / abs(ploss)
    grad = train_runs.grad_rel_errs(kgrads, pgrads)
    del runs, kgrads, pgrads
    torch.cuda.empty_cache()
    fields = dict(loss_kernel=kloss, loss_plain=ploss, loss_rel_err=loss_rel,
                  worst_grad_rel_err=grad["worst"],
                  worst_grad_leaf=grad["worst_leaf"],
                  median_grad_rel_err=grad["median"],
                  launches_kernel_path=klaunch, launches_plain_path=plaunch)
    problems = []
    if not (math.isfinite(kloss) and loss_rel <= 1e-5):
        problems.append(f"loss {kloss} vs plain {ploss}")
    if not grad["worst"] <= 1e-4:
        problems.append(f"{grad['worst_leaf']} gradient off by "
                        f"{grad['worst']}")
    if klaunch != dict.fromkeys(KERNELS, n_layer) or any(plaunch.values()):
        problems.append(f"launches {klaunch} (kernel), {plaunch} (plain)")
    return fields, problems


def phase_train_f32():
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.tools import train_runs

    cfg = gpt2.GPT2Config.gpt2_124m(attention="flash", loss_chunks=8,
                                    dtype=torch.float32)
    batch = gpt2.synthetic_batch(4, 2, 256, cfg.vocab_size)
    fields, problems = _f32_kernel_vs_plain(
        lambda: train_runs.step_grads(cfg, batch), cfg.n_layer)
    emit("train_f32", **fields,
         tolerance={"loss": "1e-5 relative", "grads": "1e-4 relative norm "
                    "per parameter (f32 sums in another order)"})
    if problems:
        raise AssertionError("train_f32: " + "; ".join(problems))


def phase_train_bf16():
    from ray_tpu_torch.tools import train_runs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    losses, step_ms = train_runs.train_bf16()
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    n_steps = train_runs.WARMUP + train_runs.TIMED
    emit("train_bf16", config="gpt2_124m attention=flash loss_chunks=8 "
         "remat=False bf16/f32-params AdamW", batch=train_runs.BATCH,
         seq=train_runs.SEQ, steps=n_steps, step_ms=step_ms,
         tokens_per_s=train_runs.BATCH * train_runs.SEQ / step_ms * 1e3,
         losses=losses, launches=launches, peak_memory_bytes=peak)
    problems = _loss_problems(losses)
    want = GPT2_124M["n_layer"] * n_steps
    if launches != dict.fromkeys(KERNELS, want):
        problems.append(f"launches {launches}, want {want} each")
    if problems:
        raise AssertionError("train_bf16: " + "; ".join(problems))
    return launches, step_ms, losses


# Llama. The f32 check cuts Llama-2-7B to 4 of its 32 layers; serving runs
# Llama-2-7B and Llama-3-8B at full depth and width with bf16 weights;
# training cuts Llama-2-7B to 2 layers (full depth needs ~108 GB of f32
# weights, gradients and AdamW moments).
LLAMA_F32_LAYERS = 4
LLAMA_SERVE = {"batch": 4, "prompt": 512, "new_tokens": 32}
LLAMA_TRAIN = {"layers": 2, "batch": 2, "seq": 2048, "steps": 5}
# f32 kernel path vs plain path: max |kernel - plain| / max |plain| over
# every compared logit (f32 sums in another order through 4 layers)
LLAMA_F32_LIMIT = 1e-3
# bf16 serving, kernel path vs plain path on the same weights and tokens,
# over the prefill's last logits and every teacher-forced decode step.
# Argued before the first chip run (PERF.md): the two paths round
# attention's f32 result to bf16 at different points, and 32 bf16 layers
# carry any such difference up to bf16's own noise floor. A CPU emulation
# of a 32-layer, 256- and 512-wide Llama with random weights, perturbing
# attention's f32 output by 1e-7 to 4e-3 relative before its bf16 cast,
# gave ||d|| / ||ref|| 0.013-0.022 and max |d| 0.06-0.11 on logits of std
# ~1: the limits are 2.3x those
LLAMA_BF16_LIMITS = {"rel_norm": 5e-2, "max_abs_err": 0.25}
# bf16 training, one step's gradients, kernel path vs plain path: the
# relative error norm of the worst parameter; GPT-2-124M measured 0.0127
# on the H100 (PERF.md) and a 2-layer CPU emulation of this one 0.0072
LLAMA_GRAD_LIMIT = 5e-2


# substrings of the names of cuBLAS's matrix-product kernels
MATMUL_KERNELS = ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas")


def phase_llama_trace(serve):
    """Llama-2-7B serving once more (phase 10's weights and prompts), last,
    under the profiler: one prefill and 4 decode steps, the card's time per
    call by kernel. The idle share is taken against phase 10's host-clock
    times of the same calls (``serve``), read before any profiler session:
    after one, every launch costs the host more."""
    import gc

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import llama_runs, timing

    cfg = llama.LlamaConfig.llama2_7b()
    model = llama.init_params(cfg, _cuda_gen(20))
    llama.cast_for_serving(model, torch.bfloat16)
    B, T = LLAMA_SERVE["batch"], LLAMA_SERVE["prompt"]
    prompts = llama_runs.prompts(21, B, T, cfg.vocab_size, "cuda")
    caches = llama.init_kv_caches(cfg, B, T + 8)
    index = torch.tensor(T, device="cuda")   # on the device, as in generate

    def prefill():
        llama._prefill(model, prompts, caches)

    def decode():
        llama._decode_step(model, prompts[:, -1:], index, caches)
        index.add_(1)

    calls = {"prefill": (prefill, 1), "decode_step": (decode, 4)}
    fields = {}
    for name, (fn, n) in calls.items():
        index.fill_(T)
        kernels, per_call = timing.kernel_ms(fn, n)
        device = sum(kernels.values())
        matmul = sum(ms for k, ms in kernels.items()
                     if any(m in k.lower() for m in MATMUL_KERNELS))
        flash = sum(ms for k, ms in kernels.items() if "flash_fwd" in k)
        fields[name] = {
            "wall_ms": serve[name],
            "device_ms": device, "idle_share": 1 - device / serve[name],
            "kernels_per_call": per_call, "matmul_ms": matmul,
            "flash_fwd_ms": flash, "other_ms": device - matmul - flash,
            "top_kernels": [[k[:90], ms] for k, ms in
                            list(kernels.items())[:8]]}
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()
    emit("llama_trace", config="llama2_7b", batch=B, prompt=T,
         note="the profiler's kernel durations against phase 10's host "
              "clock of the same calls (its median prefill and decode step); "
              "decode steps here at positions 512-515", **fields)


@contextlib.contextmanager
def _sdpa_attention():
    """Route the model's flash-attention calls to torch SDPA, the control
    of the bf16 serving limits. The caches reach it whole with a live
    length ``k_len`` on the device, so it gets the kernel's mask as a
    boolean one, built on the device: query i sees key j iff j < k_len and
    j <= i + (k_len - Sq)."""
    import ray_tpu_torch.ops as ops

    kernel_path = ops.flash_attention

    def sdpa(q, k, v, *, causal=False, sm_scale=None, k_len=None, **_):
        sq, sk = q.shape[-2], k.shape[-2]
        live = sk if k_len is None else k_len
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        mask = kj < live
        if causal:
            mask = mask & (kj <= qi + (live - sq))
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm_scale)

    ops.flash_attention = sdpa
    try:
        yield
    finally:
        ops.flash_attention = kernel_path


def _cuda_gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def phase_llama_f32():
    """Llama-2-7B width, 4 layers, f32: the prefill logits and 8
    teacher-forced decode steps through the f32 kernel against the plain
    attention; then the full causal pass against a step-by-step decode."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import llama_runs

    cfg = llama.LlamaConfig.llama2_7b(n_layer=LLAMA_F32_LAYERS,
                                      dtype=torch.float32)
    model = llama.init_params(cfg, _cuda_gen(0))
    prompt_len, steps = 128, 8
    prompts = llama_runs.prompts(10, 2, prompt_len, cfg.vocab_size, "cuda")
    tokens = llama.generate(model, prompts, steps + 1)
    _zero_launches()
    kernel, plain = llama_runs.teacher_forced_logits_both(model, tokens,
                                                          prompt_len)
    launches = _read_launches()
    errs = llama_runs.logit_errors(kernel, plain)
    argmax_equal = all(torch.equal(x.argmax(-1), tokens[:, prompt_len + i])
                       for i, x in enumerate(kernel))
    full_pass = llama_runs.decode_equals_full_pass(
        model, llama_runs.prompts(11, 2, 12, cfg.vocab_size, "cuda"))
    del model, kernel, plain
    torch.cuda.empty_cache()
    want = {"flash_fwd": (steps + 1) * cfg.n_layer, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    emit("llama_f32", config="llama2_7b", layers=cfg.n_layer,
         depth_cut=f"{cfg.n_layer} of 32 layers", batch=2,
         prompt=prompt_len, decode_steps=steps, **errs,
         share_of_limit=errs["max_rel_to_max"] / LLAMA_F32_LIMIT,
         generate_tokens_equal_kernel_argmax=argmax_equal,
         decode_vs_full_pass=full_pass,
         decode_vs_full_pass_share=full_pass / LLAMA_F32_LIMIT,
         launches=launches,
         tolerance={"max_rel_to_max": LLAMA_F32_LIMIT,
                    "reason": "f32 sums in another order through 4 layers",
                    "decode_vs_full_pass": LLAMA_F32_LIMIT})
    problems = []
    if not errs["max_rel_to_max"] <= LLAMA_F32_LIMIT:
        problems.append(f"kernel vs plain logits {errs}")
    if not full_pass <= LLAMA_F32_LIMIT:
        problems.append(f"decode vs full pass {full_pass}")
    if launches != want:
        problems.append(f"launches {launches}, want {want}")
    if problems:
        raise AssertionError("llama_f32: " + "; ".join(problems))


def _checked_layers(n_layer):
    """The layers whose attention inputs are held: first, middle, last."""
    return (0, n_layer // 2, n_layer - 1)


def _digest(tokens):
    """sha256 of the tokens' int64 bytes, to compare runs and trees."""
    return hashlib.sha256(tokens.to(torch.int64).cpu().numpy().tobytes()
                          ).hexdigest()


def _real_activation_checks(inputs):
    """Each captured flash-attention call (label, folded (q, k, v), its
    keywords) run again through the kernel and held against the plain
    version on the same real activations, element by element at ``TOLS``,
    as ``_check_flash`` holds random inputs."""
    rows = []
    for label, (q, k, v), kw in inputs:
        causal, k_len = kw.get("causal", False), kw.get("k_len")
        ok, out_err, lse_err, share = _check_flash(q, k, v, causal, k_len)
        rows.append({"call": label, "bh": q.shape[0], "sq": q.shape[1],
                     "sk": k.shape[1], "d": q.shape[2],
                     "k_len": None if k_len is None else int(k_len),
                     "causal": causal, "dtype": str(q.dtype).split(".")[-1],
                     "ok": ok, "out_err": out_err, "lse_err": lse_err,
                     "share_of_limit": share})
    return rows


def _activation_problems(rows):
    return [f"kernel vs plain on the real activations of {r['call']}: "
            f"error {r['out_err']}, {r['share_of_limit']} of its limit"
            for r in rows if not r["ok"]]


def phase_llama_serve(name, cfg, seed):
    """One model at full width, bf16 Dense and Embed weights, f32 norm
    scales: ``generate`` over 4 prompts of 512 random tokens, 32 greedy new
    tokens each, launch counts zeroed just before and read just after; its
    prefill and decode steps timed again; the prefill's last logits and
    every teacher-forced decode step against the plain attention, and the
    same for torch SDPA in the kernel's place, as a control of how much the
    bf16 limits can see."""
    import gc

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import llama_runs

    gc.collect()
    torch.cuda.empty_cache()
    B, T, new = (LLAMA_SERVE[k] for k in ("batch", "prompt", "new_tokens"))
    t0 = time.perf_counter()
    model = llama.init_params(cfg, _cuda_gen(seed))
    llama.cast_for_serving(model, torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    prompts = llama_runs.prompts(seed + 1, B, T, cfg.vocab_size, "cuda")
    llama.generate(model, prompts[:, :16], 2)  # cuBLAS and the library warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    tokens, generate_s = llama_runs.time_generate(model, prompts, new)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = [llama_runs.time_steps(model, tokens, T,
                                   counts=(_zero_launches, _read_launches))
             for _ in range(3)]
    kernel, plain = llama_runs.teacher_forced_logits_both(model, tokens, T)
    errs = llama_runs.logit_errors(kernel, plain)
    with _sdpa_attention():
        control = llama_runs.logit_errors(
            llama_runs.teacher_forced_logits(model, tokens, T), plain)
    finite = all(bool(torch.isfinite(x.float()).all()) for x in kernel)
    argmax_equal = sum(int((x.argmax(-1) == tokens[:, T + i]).sum())
                       for i, x in enumerate(kernel)) / (B * new)
    activations = _real_activation_checks(llama_runs.attention_inputs(
        model, tokens, T, _checked_layers(cfg.n_layer)))
    del model, kernel, plain
    gc.collect()
    torch.cuda.empty_cache()

    prefill_ms = sorted(x["prefill_ms"] for x in steps)
    decode_ms = sorted(x["decode_ms_per_token"] for x in steps)
    # bounds: a decode step reads every weight but the embedding table (B
    # rows of it) and the live K and V of every layer; the prefill reads
    # the same weights (B x T rows of the table) and does the matmuls' 2
    # FLOPs per weight and token and attention's 4·d per live pair
    d, kv_row = cfg.head_dim, cfg.n_kv_head * cfg.head_dim * 2
    embed_bytes = cfg.vocab_size * cfg.n_embd * 2
    step_weights = weight_bytes - embed_bytes + B * cfg.n_embd * 2
    kv_reads = [2 * cfg.n_layer * B * (t + 1) * kv_row
                for t in range(T, T + new - 1)]
    decode_bound_weights = step_weights / HBM_BYTES_PER_S * 1e3
    decode_bound = (step_weights + sum(kv_reads) / len(kv_reads)) \
        / HBM_BYTES_PER_S * 1e3
    matmul_params = (cfg.num_params() - cfg.vocab_size * cfg.n_embd
                     - cfg.n_embd * (2 * cfg.n_layer + 1))
    prefill_flops = (2 * matmul_params * B * T + 4 * d * cfg.n_layer
                     * _live_pairs(B * cfg.n_head, T, T, True))
    prefill_bytes = weight_bytes - embed_bytes + B * T * cfg.n_embd * 2
    prefill_bound, prefill_bound_by = _bound(prefill_bytes, prefill_flops)
    want = {"flash_fwd": cfg.n_layer * new, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    want_steps = {"prefill_launches": dict(want, flash_fwd=cfg.n_layer),
                  "decode_launches": dict(want, flash_fwd=cfg.n_layer
                                          * (new - 1))}
    step_launches = {k: [x[k] for x in steps] for k in want_steps}
    emit("llama_serve", config=name, layers=cfg.n_layer,
         n_kv_head=cfg.n_kv_head, vocab=cfg.vocab_size, batch=B, prompt=T,
         new_tokens=new, cache_len=T + new, weight_bytes=weight_bytes,
         init_s=init_s, generate_s=generate_s,
         tokens_per_s=B * new / generate_s,
         prefill_ms=prefill_ms[1], prefill_ms_runs=prefill_ms,
         prefill_bound_ms=prefill_bound, prefill_bound_by=prefill_bound_by,
         decode_ms_per_token=decode_ms[1], decode_ms_runs=decode_ms,
         decode_bound_ms_weights=decode_bound_weights,
         decode_bound_ms=decode_bound,
         decode_share_of_bound=decode_bound / decode_ms[1],
         peak_memory_bytes=peak, launches=launches, **step_launches,
         generated_tokens_equal_kernel_argmax=argmax_equal, finite=finite,
         tokens_sha256=_digest(tokens), real_activations=activations,
         **errs, share_of_limits={k: errs[k] / v
                                  for k, v in LLAMA_BF16_LIMITS.items()},
         tolerance={**LLAMA_BF16_LIMITS, "reason": "2.3x what a CPU "
                    "emulation of bf16 noise over 32 layers gave (PERF.md)"},
         control_sdpa={**control, "share_of_limits": {
             k: control[k] / v for k, v in LLAMA_BF16_LIMITS.items()},
             "within_limits": all(control[k] <= v for k, v in
                                  LLAMA_BF16_LIMITS.items()),
             "note": "torch SDPA in the kernel's place against the plain "
                     "attention: not gated, it shows what the limits "
                     "can tell apart"})
    problems = []
    if launches != want:
        problems.append(f"launches {launches}, want {want}")
    for k, w in want_steps.items():
        if any(x != w for x in step_launches[k]):
            problems.append(f"{k} {step_launches[k]}, want {w}")
    if not finite:
        problems.append("non-finite logits")
    problems += _activation_problems(activations)
    for k, limit in LLAMA_BF16_LIMITS.items():
        if not errs[k] <= limit:
            problems.append(f"kernel vs plain {k} {errs[k]} > {limit}")
    if problems:
        raise AssertionError(f"llama_serve {name}: " + "; ".join(problems))
    return {"prefill_launches": steps[0]["prefill_launches"]["flash_fwd"],
            "decode_launches": steps[0]["decode_launches"]["flash_fwd"],
            "prefill": prefill_ms[1], "decode_step": decode_ms[1],
            "tokens": tokens.cpu()}


def phase_llama_train():
    """Llama-2-7B width, 2 layers, bf16 compute over f32 weights, batch 2 x
    2048: one step's gradients through the kernels against the plain
    attention's, then 5 AdamW steps on one batch with launch counts zeroed
    just before and read just after."""
    import gc

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools import llama_runs

    c = LLAMA_TRAIN
    cfg = llama.LlamaConfig.llama2_7b(n_layer=c["layers"])
    batch = llama.synthetic_batch(12, c["batch"], c["seq"], cfg.vocab_size)
    grads = llama_runs.grads_both(cfg, batch, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    run = llama_runs.train(cfg, batch, c["steps"], "cuda")
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    losses, step_ms = run["losses"], run["step_ms"]
    timed = sorted(step_ms[1:])
    step_median = timed[len(timed) // 2]
    emit("llama_train", config="llama2_7b", layers=cfg.n_layer,
         depth_cut=f"{cfg.n_layer} of 32 layers", batch=c["batch"],
         seq=c["seq"], steps=c["steps"], losses=losses, step_ms=step_ms,
         step_ms_median_after_first=step_median,
         tokens_per_s=c["batch"] * c["seq"] / step_median * 1e3,
         launches=launches, peak_memory_bytes=peak, grads_vs_plain=grads,
         tolerance={"worst_grad_rel_err": LLAMA_GRAD_LIMIT})
    problems = _loss_problems(losses)
    want = cfg.n_layer * c["steps"]
    if launches != dict.fromkeys(KERNELS, want):
        problems.append(f"launches {launches}, want {want} each")
    if not grads["worst"] <= LLAMA_GRAD_LIMIT:
        problems.append(f"{grads['worst_leaf']} gradient off by "
                        f"{grads['worst']}")
    if problems:
        raise AssertionError("llama_train: " + "; ".join(problems))
    return launches, step_median


# ViT-B/16 (224^2, batch 64: one Tune trial per card) and ResNet-50 with
# the CIFAR stem (32^2, batch 256), both bf16 over f32 weights with the
# reference's AdamW at lr 1e-4: at its default 1e-3, with no warm-up, the
# first Adam steps overshoot at full width, in the reference as in the
# port (PERF.md), and the loss of 5 steps rises. The f32 check cuts
# ViT-B/16 to 2 of its 12 layers
VIT = {"batch": 64, "steps": 5, "lr": 1e-4, "f32_layers": 2,
       "f32_batch": 16}
RESNET = {"batch": 256, "steps": 5, "lr": 1e-4}
# f32 kernel path vs plain path: max |kernel - plain| / max |plain| over
# the logits (f32 sums in another order through 2 layers; Llama's 4 layers
# measured 2.5e-6 of its largest logit, PERF.md)
VIT_F32_LIMIT = 1e-4


def _train_fields(run, batch):
    """Step ms (the median of the steps after the first) and images/s."""
    timed = sorted(run["step_ms"][1:])
    median = timed[len(timed) // 2]
    return {"losses": run["losses"], "step_ms": run["step_ms"],
            "step_ms_median_after_first": median,
            "images_per_s": batch / median * 1e3}


def phase_vit():
    """ViT-B/16 at full depth and width, bf16 over f32 weights, batch 64:
    5 AdamW steps on one batch, launch counts zeroed just before and read
    just after (12 of each kernel per step); the kernel held on the real
    attention inputs of layers 0, 6 and 11 (non-causal, S 197); then an
    f32 pass cut to 2 layers at full width, kernel path against plain
    path on the logits."""
    import gc

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.tools import vision_runs

    cfg = vision.ViTConfig.vit_b16()
    batch = vision.synthetic_image_batch(40, VIT["batch"], cfg.image_size,
                                         cfg.num_classes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    run = vision_runs.train(cfg, batch, VIT["steps"], "cuda", VIT["lr"])
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    net = vision_runs.model(cfg, "cuda")
    n_params = sum(p.numel() for p in net.parameters())
    activations = _real_activation_checks(vision_runs.attention_inputs(
        net, batch["image"], _checked_layers(cfg.n_layer)))
    del net
    f32 = vision.ViTConfig.vit_b16(n_layer=VIT["f32_layers"],
                                   dtype=torch.float32)
    net = vision_runs.model(f32, "cuda")
    _zero_launches()
    kernel, plain = vision_runs.logits_both(net,
                                            batch["image"][:VIT["f32_batch"]])
    f32_launches = _read_launches()
    f32_err = float((kernel - plain).abs().max() / plain.abs().max())
    del net, kernel, plain, batch
    gc.collect()
    torch.cuda.empty_cache()
    fields = _train_fields(run, VIT["batch"])
    emit("vit_train", config="vit_b16", image_size=cfg.image_size,
         layers=cfg.n_layer, seq=cfg.seq_len, params=n_params,
         batch=VIT["batch"], steps=VIT["steps"], lr=VIT["lr"], **fields,
         launches=launches, peak_memory_bytes=peak,
         real_activations=activations,
         f32_check={"layers": f32.n_layer, "batch": VIT["f32_batch"],
                    "max_rel_to_max": f32_err,
                    "share_of_limit": f32_err / VIT_F32_LIMIT,
                    "launches": f32_launches},
         tolerance={"f32_max_rel_to_max": VIT_F32_LIMIT,
                    "real_activations": _tol_fields(torch.bfloat16)})
    problems = _loss_problems(run["losses"])
    want = cfg.n_layer * VIT["steps"]
    if launches != dict.fromkeys(KERNELS, want):
        problems.append(f"launches {launches}, want {want} each")
    problems += _activation_problems(activations)
    if not f32_err <= VIT_F32_LIMIT:
        problems.append(f"f32 kernel vs plain logits {f32_err}")
    if f32_launches != {"flash_fwd": f32.n_layer, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0}:
        problems.append(f"f32 pass launches {f32_launches}")
    if problems:
        raise AssertionError("vit_train: " + "; ".join(problems))
    return launches, fields["step_ms_median_after_first"], run["losses"]


def phase_resnet():
    """ResNet-50 with the CIFAR stem, bf16 over f32 weights, batch 256 of
    32^2 images: 5 AdamW steps on one batch, launch counts zeroed just
    before and read just after; its convolutions are cuDNN's, so no flash
    kernel may launch."""
    import gc

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.tools import vision_runs

    cfg = vision.ResNetConfig.resnet50_cifar()
    batch = vision.synthetic_image_batch(50, RESNET["batch"],
                                         cfg.image_size, cfg.num_classes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    run = vision_runs.train(cfg, batch, RESNET["steps"], "cuda",
                            RESNET["lr"])
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    fields = _train_fields(run, RESNET["batch"])
    emit("resnet_train", config="resnet50_cifar",
         stage_sizes=list(cfg.stage_sizes), image_size=cfg.image_size,
         batch=RESNET["batch"], steps=RESNET["steps"], lr=RESNET["lr"],
         **fields, launches=launches, peak_memory_bytes=peak)
    problems = _loss_problems(run["losses"])
    if any(launches.values()):
        problems.append(f"flash kernels launched: {launches}")
    if problems:
        raise AssertionError("resnet_train: " + "; ".join(problems))
    return run["losses"], fields["images_per_s"]


# Switch-MoE LM, ``MoELMConfig()`` (GPT-2 width, 12 layers, 8 experts, an
# MoE FFN in every second block), bf16 over f32 weights, the MoE FFN in f32:
# batch 16 x 1024, GPT-2's training shape, so that the two steps compare at
# the same tokens; the reference's lr 3e-4. The f32 check cuts it to 2
# layers (one dense block, one MoE block)
MOE = {"batch": 16, "seq": 1024, "steps": 5, "lr": 3e-4, "f32_layers": 2,
       "f32_batch": 2, "f32_seq": 256}
# H100 SXM published f32 rate outside the tensor cores (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12


def phase_moe_train():
    """MoELMConfig() at full width and depth, bf16 over f32 weights, batch
    16 x 1024: 5 AdamW steps on one batch with launch counts zeroed just
    before the steps and read just after (12 of each kernel per step); the
    reference's one-hot dispatch for 2 steps on the same weights and batch
    (the yardstick); then the f32 check, 2 layers at full width, kernel
    path against plain path on one step's loss and gradients."""
    import gc

    from ray_tpu_torch.models import gpt2, moe_lm
    from ray_tpu_torch.tools import moe_runs

    cfg = moe_lm.MoELMConfig()
    batch = gpt2.synthetic_batch(60, MOE["batch"], MOE["seq"],
                                 cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = moe_runs.train(cfg, batch, MOE["steps"], "cuda", MOE["lr"],
                         counts=(_zero_launches, _read_launches))
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with moe_runs.one_hot_dispatch():
        yard = moe_runs.train(cfg, batch, 2, "cuda", MOE["lr"])
    yard_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()

    f32 = moe_lm.MoELMConfig(n_layer=MOE["f32_layers"], dtype=torch.float32)
    f32_batch = gpt2.synthetic_batch(61, MOE["f32_batch"], MOE["f32_seq"],
                                     cfg.vocab_size)
    f32_fields, f32_problems = _f32_kernel_vs_plain(
        lambda: moe_runs.step_grads(f32, f32_batch, "cuda"), f32.n_layer)
    del batch, f32_batch
    gc.collect()
    torch.cuda.empty_cache()

    fields = _train_fields(run, MOE["batch"])
    median = fields.pop("step_ms_median_after_first")
    fields.pop("images_per_s")
    yard_rel = abs(yard["losses"][0] - run["losses"][0]) / abs(
        run["losses"][0])
    emit("moe_train", config="MoELMConfig() bf16/f32-params, MoE FFN f32",
         layers=cfg.n_layer, moe_blocks=sum(map(cfg.is_moe,
                                                range(cfg.n_layer))),
         experts=cfg.num_experts, capacity_factor=cfg.capacity_factor,
         params=run["params"], batch=MOE["batch"], seq=MOE["seq"],
         steps=MOE["steps"], lr=MOE["lr"], **fields, lm=run["lm"],
         aux=run["aux"], step_ms_median_after_first=median,
         tokens_per_s=MOE["batch"] * MOE["seq"] / median * 1e3,
         launches=run["launches"], peak_memory_bytes=peak,
         drop_shares=run["drop_shares"],
         one_hot_yardstick={"losses": yard["losses"],
                            "step_ms": yard["step_ms"],
                            "loss_rel_to_index": yard_rel,
                            "drop_shares_start": yard["drop_shares"]["start"],
                            "peak_memory_bytes": yard_peak},
         f32_check={"layers": f32.n_layer, "batch": MOE["f32_batch"],
                    "seq": MOE["f32_seq"], **f32_fields},
         tolerance={"one_hot_loss_rel": 1e-6, "f32_loss": "1e-5 relative",
                    "f32_grads": "1e-4 relative norm per parameter",
                    "aux": "finite and > 0.1 at every step"})
    problems = _loss_problems(run["losses"])
    want = cfg.n_layer * MOE["steps"]
    if run["launches"] != dict.fromkeys(KERNELS, want):
        problems.append(f"launches {run['launches']}, want {want} each")
    if not all(math.isfinite(a) and a > 0.1 for a in run["aux"]):
        problems.append(f"aux {run['aux']}")
    if not yard_rel <= 1e-6:
        problems.append(f"one-hot loss {yard['losses'][0]} vs index "
                        f"{run['losses'][0]}")
    if yard["drop_shares"]["start"] != run["drop_shares"]["start"]:
        problems.append("the one-hot dispatch drops other tokens")
    problems += [f"f32 {p}" for p in f32_problems]
    if problems:
        raise AssertionError("moe_train: " + "; ".join(problems))
    return run["launches"], median, run["losses"]


# the host ops whose kernels are the MoE dispatch and combine (index_copy,
# index_select and index_add_ in the backward; the embedding lookup is an
# index_select too), and the expert products (the model's only bmm)
INDEX_OPS = ("aten::index_copy", "aten::index_select", "aten::index_add_")
EXPERT_OPS = ("aten::bmm",)


def phase_moe_trace(step_ms):
    """One bf16 step of phase 17's model and batch, last, under the
    profiler: the card's time by class of kernel (each flash kernel, matrix
    products, the rest) and by the host op that launched it (the expert
    products, the MoE dispatch and combine), the flash kernels' device ms
    per launch at the path's shape, and the device's idle share against
    phase 17's host-clock step (``step_ms``)."""
    import gc

    from ray_tpu_torch.models import gpt2, moe_lm
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.tools import moe_runs, timing

    cfg = moe_lm.MoELMConfig()
    batch = gpt2.synthetic_batch(60, MOE["batch"], MOE["seq"],
                                 cfg.vocab_size)
    model, optimizer, step = moe_runs.state(cfg, "cuda", MOE["lr"])
    _zero_launches()
    kernels, per_call = timing.kernel_ms(
        lambda: step(model, optimizer, batch), 1)
    launches = _read_launches()   # two steps: one outside the profiler
    by_op = timing.kernel_ms_by_op(lambda: step(model, optimizer, batch), 1)
    del model, optimizer, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    device = sum(kernels.values())
    classes = {**{name: (name,) for name in KERNELS},
               "matmul": MATMUL_KERNELS}
    split = dict.fromkeys(classes, 0.0)
    for k, ms in kernels.items():
        for name, keys in classes.items():
            if any(key in k.lower() for key in keys):
                split[name] += ms
                break
    per_launch = {name: split[name] / cfg.n_layer for name in KERNELS}
    ops = {"expert_products": sum(by_op.get(op, 0.0) for op in EXPERT_OPS),
           "moe_dispatch_combine": sum(by_op.get(op, 0.0)
                                       for op in INDEX_OPS)}
    # the expert products' least time: E*C rows of each MoE block through
    # two products forward and four backward, 2 * rows * D * 4D FLOP each,
    # at the f32 rate (they run in f32)
    D, E = cfg.n_embd, cfg.num_experts
    rows = E * moe.expert_capacity(MOE["batch"] * MOE["seq"], E,
                                   cfg.capacity_factor)
    blocks = sum(map(cfg.is_moe, range(cfg.n_layer)))
    expert_bound_ms = (blocks * 6 * 2 * rows * D * 4 * D / F32_FLOPS_PER_S
                       * 1e3)
    emit("moe_trace", config="MoELMConfig()", batch=MOE["batch"],
         seq=MOE["seq"], host_step_ms=step_ms, device_ms=device,
         idle_share=1 - device / step_ms, kernels_per_step=per_call,
         device_ms_by_class={**split, "other": device - sum(split.values())},
         device_ms_by_op=ops, expert_products_bound_ms=expert_bound_ms,
         ops={"expert_products": EXPERT_OPS,
                                   "moe_dispatch_combine": INDEX_OPS},
         top_ops=[[op, ms] for op, ms in list(by_op.items())[:14]],
         flash_device_ms_per_launch=per_launch,
         flash_shape={"bh": MOE["batch"] * cfg.n_head, "s": MOE["seq"],
                      "d": cfg.n_embd // cfg.n_head, "causal": True,
                      "dtype": "bfloat16"},
         launches_two_steps=launches,
         top_kernels=[[k[:90], ms] for k, ms in list(kernels.items())[:14]],
         note="the profiler's kernel durations of one step against phase "
              "17's median host-clock step")
    if launches != dict.fromkeys(KERNELS, 2 * cfg.n_layer):
        raise AssertionError(f"moe_trace: launches {launches}")


def _probed_llm_server():
    """``LLMServer`` plus ``probe``: the replica's own launch counts (launch
    counters are per process, so the driver's read none of the replica's),
    its forwards, pid, device and the seconds its ``__init__`` took (the
    model's build on the card); ``reset=True`` zeroes the counts and the
    forwards first. Built in a function, so the class travels to the
    replica by value."""
    from ray_tpu_torch.serve.llm import LLMServer

    class ProbedLLMServer(LLMServer):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            self.init_s = time.perf_counter() - t0

        def probe(self, reset=False):
            import os as _os

            import torch as _torch

            from ray_tpu_torch.ops import attention as attn

            if reset:
                attn.zero_launches()
                self.model.forwards = 0
            dev = self.model.device
            return {"launches": attn.read_launches(),
                    "forwards": self.model.forwards, "pid": _os.getpid(),
                    "init_s": self.init_s,
                    "reserved_mib": _torch.cuda.memory_reserved(dev) / 2**20
                    if dev.type == "cuda" else None,
                    "device": str(dev),
                    "device_name": _torch.cuda.get_device_name(dev)
                    if dev.type == "cuda" else None}

    return ProbedLLMServer


def _http_stream(port, tokens, max_tokens):
    """POST one request to the port's proxy; (tokens, t_sent, [t_token])
    with one host-clock stamp per streamed token line."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm", method="POST",
        data=json.dumps({"tokens": tokens,
                         "max_tokens": max_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    toks, stamps = [], []
    with urllib.request.urlopen(req, timeout=120) as r:
        if r.status != 200:
            raise AssertionError(f"HTTP {r.status} from the proxy")
        for line in r:
            if line.strip():
                toks.append(json.loads(line)["token"])
                stamps.append(time.perf_counter())
    return toks, t0, stamps


def _wait_for_no_processes(session_dir):
    """The session's processes left 30 s after its shutdown."""
    from ray_tpu_torch.tools.cluster_runs import session_processes

    deadline = time.time() + 30
    while time.time() < deadline and session_processes(session_dir):
        time.sleep(0.5)
    return session_processes(session_dir)


def _card_memory_of(pid):
    """MiB of card memory ``nvidia-smi`` lists for ``pid``; None where it
    lists no compute process of that pid."""
    for line in _run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                      "--format=csv,noheader,nounits"]).splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) == 2 and fields[0] == str(pid):
            return int(fields[1])
    return None


def _card_used_mib():
    """MiB in use on the card, every process's (``nvidia-smi``)."""
    return int(_run(["nvidia-smi", "--query-gpu=memory.used",
                     "--format=csv,noheader,nounits"]).splitlines()[0])


def phase_serve_run(smi, bf16_streams, after=None):
    """GPT-2-124M served by ``serve.run`` from a replica actor on the card,
    requests over HTTP through the port's proxy: phase 6's prompts and
    weights, so its streams (``bf16_streams``) are the expected tokens.
    ``after(port)`` runs in the same cluster once (a) and (b) are done;
    what it returns is returned."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.worker import global_worker

    os.environ["RAY_TPU_TORCH_gpu_autodetect"] = "1"  # the raylet's probe
    t_init = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    os.environ.pop("RAY_TPU_TORCH_gpu_autodetect")
    init_s = time.perf_counter() - t_init
    session_dir = global_worker.node.session_dir
    resources = rt.cluster_resources()
    labels = rt.nodes()[0].get("labels") or {}
    card = smi.split(",")[0].strip()
    problems = []
    if resources.get("GPU") != 1.0:
        problems.append(f"cluster advertises GPU {resources.get('GPU')}")
    if labels.get("gpu-device-kind") != card:
        problems.append(f"gpu-device-kind {labels.get('gpu-device-kind')!r} "
                        f"is not nvidia-smi's {card!r}")
    prompts = phase6_prompts()
    try:
        app = serve.deployment(_probed_llm_server(), name="llm").options(
            ray_actor_options={"num_gpus": 1}).bind(
                real_model=True, kv_dim=768, page_tokens=16, max_pages=512,
                max_running=8, prefix_cache_pages=128,
                model_kwargs=dict(attention="flash", dtype=torch.bfloat16,
                                  **GPT2_124M))
        t_run = time.perf_counter()
        handle = serve.run(app, route_prefix="/llm")
        start_s = time.perf_counter() - t_run
        port = serve.http_port()
        # one request first: a fresh replica's first forward and the
        # proxy's first route cost what the later ones do not; its prompt
        # shares no page with phase 6's
        first = _http_stream(
            port, np.random.default_rng(19).integers(0, 50257, 64).tolist(),
            2)
        probe = handle.options(method_name="probe")
        probe.remote(reset=True).result(timeout_s=60)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as pool:
            results = list(pool.map(
                lambda p: _http_stream(port, p, 16), prompts))
        results.append(_http_stream(port, prompts[0], 16))
        wall = time.perf_counter() - t0
        replica = probe.remote().result(timeout_s=60)
        replica_mib = _card_memory_of(replica["pid"])
        driver_mib = _card_memory_of(os.getpid())
        info = handle.options(method_name="debug_info").remote().result(
            timeout_s=60)
        failover = _gcs_failover(port, prompts, probe)
        after_out = after(port) if after else None
    finally:
        serve.shutdown()
        rt.shutdown()
    from ray_tpu_torch.tools.cluster_runs import session_processes

    deadline = time.time() + 30
    while time.time() < deadline and (
            session_processes(session_dir)
            or _card_memory_of(replica["pid"]) is not None):
        time.sleep(0.5)
    left = session_processes(session_dir)
    replica_mib_after = _card_memory_of(replica["pid"])

    streams = [r[0] for r in results]
    ttft = [r[2][0] - r[1] for r in results]
    total_tokens = sum(len(s) for s in streams)
    launches, forwards = replica["launches"], replica["forwards"]
    emit("serve_run", http_port=port, init_s=init_s, replica_start_s=start_s,
         replica_model_init_s=replica["init_s"],
         first_request_ttft_s=first[2][0] - first[1],
         gpu=resources.get("GPU"), gpu_device_kind=labels.get(
             "gpu-device-kind"), replica_pid=replica["pid"],
         driver_pid=os.getpid(), replica_device=replica["device"],
         replica_device_name=replica["device_name"],
         prompt_lens=[len(p) for p in prompts] + [32], tokens=streams,
         ttft_s=ttft, total_tokens=total_tokens, wall_s=wall,
         tokens_per_s=total_tokens / wall, forwards=forwards,
         launches=launches, hit_rate=info["hit_rate"],
         arena_backed=info["arena_backed"], counts=info["counts"],
         replica_card_mib={"serving": replica_mib,
                           "after": replica_mib_after},
         driver_card_mib=driver_mib, processes_left=left,
         note="launches and forwards are the replica's, zeroed just before "
              "the requests and read just after (after the first request); "
              "TTFT from sending a request to its first streamed line, "
              "host clock")
    if any(len(s) != 16 for s in streams):
        problems.append("a stream did not give 16 tokens")
    if streams != list(bf16_streams):
        problems.append("the streams differ from phase 6's in-process ones")
    if streams[-1] != streams[0]:
        problems.append("the repeated prompt streamed other tokens")
    if not info["hit_rate"] > 0:
        problems.append("the repeated prompt missed the prefix cache")
    if replica["pid"] == os.getpid():
        problems.append("the replica ran in the driver's process")
    if not replica["device"].startswith("cuda") or \
            replica["device_name"] != torch.cuda.get_device_name(0):
        problems.append(f"the replica's model is on {replica['device']}")
    if forwards != 16 * len(streams):
        problems.append(f"{forwards} forwards for {len(streams)} x 16 tokens")
    if launches["flash_fwd"] != GPT2_124M["n_layer"] * forwards or \
            launches["flash_fwd"] == 0:
        problems.append(f"flash_fwd launched {launches['flash_fwd']} times "
                        f"for {forwards} forwards of "
                        f"{GPT2_124M['n_layer']} layers")
    if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        problems.append(f"serving launched backward kernels: {launches}")
    if info["arena_backed"] is not True:
        problems.append("the replica's KV pool is not arena-backed")
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    if driver_mib is not None and not replica_mib:
        # nvidia-smi lists this namespace's pids (it lists the driver's),
        # so it must list the replica's while it serves
        problems.append("nvidia-smi lists no card memory of the replica")
    if replica_mib_after is not None:
        problems.append(f"the replica's pid still holds {replica_mib_after} "
                        f"MiB of the card after shutdown")
    problems += _gcs_failover_problems(failover, replica, bf16_streams, smi)
    if problems:
        raise AssertionError("serve_run: " + "; ".join(problems))
    return after_out


def phase_serve_multiplex_redeploy(smi, port, bf16_streams):
    """Phase 37 in phase 19's cluster (``port`` its proxy's): the
    multiplexed GPT-2 deployment shipped by ``runtime_env`` and its
    redeploy under load (``tools/multiplex_runs.drive``). Returns the
    multiplexed replica's launch counts."""
    import shutil
    import tempfile

    from ray_tpu_torch import serve
    from ray_tpu_torch.tools import multiplex_runs as mx

    # phase 19's replica holds the card's whole lease
    serve.delete("default")
    model_kwargs = dict(attention="flash", dtype=torch.bfloat16, **GPT2_124M)
    prompts = phase6_prompts()
    prompts.append(prompts[0])
    # the seed-0 model's tokens are phase 6's streams (its in-process
    # server's GPT2LLM is seed 0); models 1 and 2 decode here, on a thread
    # while the replica starts
    others = [i for i, model_id in enumerate(mx.IDS) if model_id != "0"]
    root = tempfile.mkdtemp(prefix="serve_multiplex_")
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            decoded = pool.submit(
                mx.reference_tokens, model_kwargs, "cuda",
                [prompts[i] for i in others], [mx.IDS[i] for i in others],
                16)
            out = mx.drive(root, port, prompts, model_kwargs)
            decoded = dict(zip(others, decoded.result()))
        serve.delete(mx.APP)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    expected = [decoded[i] if i in decoded else list(bf16_streams[i])
                for i in range(len(prompts))]
    # the rollout's request is the last prompt's (phase 6's 32-token one,
    # model 1) with one token
    assert prompts[-1] == prompts[0] and mx.IDS[-1] == mx.ROLLOUT_ID
    rollout_expected = expected[-1][:mx.ROLLOUT_TOKENS]
    v1 = out["v1"]
    rollout = out["rollout"]
    emit("serve_multiplex_redeploy", ids=list(mx.IDS),
         prompt_lens=[len(p) for p in prompts],
         tokens=[a["body"].get("tokens") if isinstance(a["body"], dict)
                 else a["body"] for a in out["answers"]],
         loads=v1["loads"], resident=v1["resident"],
         forwards=v1["forwards"], launches=v1["launches"],
         launches_per_forward=v1["launches"]["flash_fwd"] / v1["forwards"]
         if v1["forwards"] else None,
         replica_pid={"v1": v1["pid"], "v2": out["v2"]["pid"]},
         replica_device=v1["device"], replica_device_name=v1["device_name"],
         v1_start_s=out["v1_start_s"], answers_s=out["answers_s"],
         serve_run_s=out["serve_run_s"], v1_gone_s=out["v1_gone_s"],
         rollout_requests=out["rollout_requests"],
         serve_run_to_first_v2_s=out["serve_run_to_first_v2_s"],
         client_answers=len(rollout),
         statuses=sorted({r["status"] for r in rollout}),
         tags=mx.tag_runs([r["tag"] for r in rollout]),
         nvidia_smi=smi,
         note="launches and forwards are the multiplexed replica's, zeroed "
              "before its 5 answers and read after; rollout_requests are "
              "the client's requests sent from serve.run of v2 on, tags "
              "the runs of every client answer's version in order; "
              "seconds on the host clock from serve.run's call")
    problems = mx.problems(out, expected, rollout_expected,
                           GPT2_124M["n_layer"], on_card=True)
    if v1["device_name"] != torch.cuda.get_device_name(0):
        problems.append(f"the replica's models are on {v1['device_name']}")
    if problems:
        raise AssertionError("serve_multiplex_redeploy: "
                             + "; ".join(problems))
    return v1["launches"]


def phase_observe_dag_actor(smi, bf16_streams):
    """Phase 38 in phase 19's cluster, after phase 37: a GPT-2 actor at
    half a card driven by a compiled DAG, profiled, scraped, traced, listed
    and its logs read back (``tools/observe_runs.drive``). Returns the
    actor's launch counts over its 4 answers."""
    from ray_tpu_torch.tools import observe_runs as ob

    model_kwargs = dict(attention="flash", dtype=torch.bfloat16, **GPT2_124M)
    prompts = phase6_prompts()
    out = ob.drive(prompts, model_kwargs)
    probe, prof = out["probe"], out["profile"]
    emit("observe_dag_actor", prompt_lens=[len(p) for p in prompts],
         tokens=out["answers"], forwards=probe["forwards"],
         launches=probe["launches"], actor_pid=probe["pid"],
         actor_device=probe["device"],
         actor_device_name=probe["device_name"],
         actor_start_s=out["start_s"], actor_model_init_s=out["init_s"],
         first_dag_call_s=out["first_dag_call_s"],
         one_token_round_trip_s=out["round_trip_s"],
         decode_s=out["decode_s"], answer_ms=out["answer_ms"],
         decode_tokens_per_s=out["tokens_per_s"],
         cpu_profile={k: prof[k] for k in (
             "cpu_samples", "cpu_processes", "actor_samples",
             "actor_share", "actor_model_stacks", "attention_stacks")},
         mem_profile={"processes": prof["mem_processes"],
                      "actor_sites": prof["mem_actor_sites"],
                      "top_sites": prof["mem_top_sites"]},
         scrape=out["scrape"], actor_log_lines=len(out["actor_log"]),
         traced_task_log=out["traced_task_log"],
         spans=out["spans"], timeline_spans=out["timeline_spans"],
         listing=out["listing"], resources=out["resources"],
         nvidia_smi=smi,
         note="launches and forwards are the actor's, zeroed before its 4 "
              "answers through the compiled DAG and read after, while both "
              "cluster profilers sampled; round trips are the median of "
              f"{ob.ROUND_TRIPS} one-token calls on the host clock; "
              "decode tokens/s of prompt 0 on the actor's clock, without a "
              "sampler and inside a CPU profile")
    problems = ob.problems(out, bf16_streams[:len(prompts)],
                           GPT2_124M["n_layer"],
                           device_name=torch.cuda.get_device_name(0))
    if problems:
        raise AssertionError("observe_dag_actor: " + "; ".join(problems))
    return probe["launches"]


# phase 19 (b): the card's memory may grow by less than half of GPT-2-124M's
# bf16 weights (124.4 M x 2 bytes) over the outage: a second model would
# add all of them
FAILOVER_MIB_GROWTH = 124.4e6 * 2 / 2 / 2**20


def _gcs_failover(port, prompts, probe):
    """Phase 19 (b) in phase 19's cluster: ``tools/gcs_failover.outage``
    under the GPT-2 replica (phase 6's 32-token prompt through the replica's
    actor during the outage), then the replica's counts zeroed, phase 6's
    4 prompts at once over HTTP and its counts read."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.tools import gcs_failover

    warm = np.random.default_rng(19).integers(0, 50257, 64).tolist()
    # nvidia-smi may list no process of a container (then the pid's MiB
    # is None): the card's whole use is read beside it
    out = gcs_failover.outage(
        "default", "llm", port, prompts[0], 16, warm, memory_of=lambda pid: {
            "pid": _card_memory_of(pid), "card_used": _card_used_mib()})
    probe.remote(reset=True).result(timeout_s=60)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(prompts)) as pool:
        out["streams_after"] = list(pool.map(
            lambda p: _http_stream(port, p, 16)[0], prompts))
    out["streams_after_s"] = time.perf_counter() - t0
    out["replica_after"] = probe.remote().result(timeout_s=60)
    return out


def _gcs_failover_problems(out, replica, bf16_streams, smi):
    """Phase 19 (b)'s line and its checks."""
    from ray_tpu_torch.tools import gcs_failover

    after = out["replica_after"]
    launches, forwards = after["launches"], after["forwards"]
    growth = {"card_used": out["mib_after"]["card_used"]
              - out["mib_before"]["card_used"],
              "replica_reserved": after["reserved_mib"]
              - replica["reserved_mib"]}
    emit("serve_run_gcs_failover",
         kill_to_first_token_s=out["kill_to_first_token_s"],
         restart_to_gcs_answering_s=out["restart_to_gcs_answering_s"],
         restart_to_replica_alive_s=out["restart_to_replica_alive_s"],
         replica_card_mib={"before": out["mib_before"]["pid"],
                           "after": out["mib_after"]["pid"]},
         card_used_mib={"before": out["mib_before"]["card_used"],
                        "after": out["mib_after"]["card_used"]},
         replica_reserved_mib={"before": replica["reserved_mib"],
                               "after": after["reserved_mib"]},
         outage_s=out["outage_s"], gcs_pid=out["gcs_pid"],
         gcs_pid_gone=out["gcs_pid_gone"],
         http_during=out["http_during"], http_before=out["http_before"],
         tokens_during=out["tokens_during"], replica=out["replica"],
         replica_pid={"before": out["pid_before"],
                      "after": out["pid_after"]},
         replica_row=out["replica_row"],
         gpu=out["cluster_resources"].get("GPU"),
         second_num_gpus_1_placed=out["second_placed"],
         controller_replicas=out["controller_replicas"],
         streams_after=out["streams_after"],
         streams_after_s=out["streams_after_s"], forwards=forwards,
         launches=launches, nvidia_smi=smi,
         note="replica_card_mib is nvidia-smi's by the replica's pid (None "
              "where it lists no process), card_used_mib the card's whole "
              "use, both read before the kill and after the restart; "
              "replica_reserved_mib torch's reserve in the replica after "
              "phase 19 (a) and after the 4 prompts; host clock: "
              "kill_to_first_token_s from the SIGKILL to the "
              "first token streamed through the replica's actor; the "
              "restart_* from restart_gcs() to a fresh connection's "
              "get_nodes answering and to the state API listing the "
              "replica ALIVE; the replica's launches and forwards zeroed "
              "after the restart and read after the 4 prompts")
    problems = []
    if not out["gcs_pid_gone"]:
        problems.append(f"the GCS pid {out['gcs_pid']} outlived kill_gcs")
    if out["tokens_during"] != list(bf16_streams[0]):
        problems.append(f"during the outage the replica streamed "
                        f"{out['tokens_during']}, not phase 6's "
                        f"{list(bf16_streams[0])}")
    during = out["http_during"]
    if during["status"] != 500 or \
            not during["s"] < gcs_failover.HTTP_DEADLINE_S:
        problems.append(f"the HTTP request during the outage: {during}")
    if out["kv_after"] != gcs_failover.KV_VALUE:
        problems.append(f"the KV key read back {out['kv_after']!r}")
    if not out["pid_before"] == out["pid_after"] == replica["pid"] or \
            out["replica_row"]["state"] != "ALIVE" or \
            out["replica_row"]["num_restarts"] != 0:
        problems.append(f"the replica after the restart: pid "
                        f"{out['pid_before']} -> {out['pid_after']}, "
                        f"{out['replica_row']}")
    if not max(growth.values()) < FAILOVER_MIB_GROWTH:
        problems.append(f"card memory grew by {growth} MiB over the outage "
                        f"(limit {FAILOVER_MIB_GROWTH})")
    if out["cluster_resources"].get("GPU") != 1.0:
        problems.append(f"after the restart the cluster advertises GPU "
                        f"{out['cluster_resources'].get('GPU')}")
    if out["second_placed"]:
        problems.append("a second num_gpus=1 actor was placed: the "
                        "restarted GCS handed the card out twice")
    if out["controller_replicas"] != [out["replica"]]:
        problems.append(f"the controller lists {out['controller_replicas']}")
    if out["streams_after"] != [list(s) for s in bf16_streams[:4]]:
        problems.append("after the restart the streams differ from phase "
                        "6's")
    if forwards != 16 * 4 or \
            launches["flash_fwd"] != GPT2_124M["n_layer"] * forwards or \
            launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        problems.append(f"after the restart {launches} for {forwards} "
                        f"forwards of 4 x 16 tokens")
    return ["gcs failover: " + p for p in problems]


# Phase 20: GPT-2-124M trained by TorchTrainer.fit() from a worker gang
# (3 steps and one checkpoint; the worker is SIGKILLed at step 2 and the
# recovered generation restores the step-1 checkpoint and takes step 2)
TRAIN_FIT = {"steps": 3, "ckpt_at": (1,), "kill_at": 2, "quant_steps": 2}


def _nccl_collective_ops():
    """Phase 36 (c), in a worker of a gang over NCCL (phase 20's quantized
    fit, world size 1): ``allreduce``, ``allgather``, ``reducescatter`` and
    ``broadcast`` of CUDA tensors through ``init_collective_group(...,
    backend="nccl")``, each against the store backend's result on the same
    inputs: {op: {"on_card", "in_place", "equal_store", "max_abs_diff"}}."""
    from ray_tpu_torch.util import collective as col

    col.init_collective_group(1, 0, backend="nccl", group_name="fit_nccl")
    col.init_collective_group(1, 0, backend="store", group_name="fit_store")
    gen = torch.Generator(device="cuda").manual_seed(36)
    x = torch.randn((8, 1024), generator=gen, device="cuda")
    calls = {"allreduce": lambda t, g: col.allreduce(t, g, op="mean"),
             "allgather": lambda t, g: col.allgather(t, g),
             "reducescatter": lambda t, g: col.reducescatter(t, g),
             "broadcast": lambda t, g: col.broadcast(t, src_rank=0,
                                                     group_name=g)}
    out = {}
    try:
        for op, call in calls.items():
            t = x.clone()
            got = call(t, "fit_nccl")
            want = call(x.clone(), "fit_store")
            parts = got if isinstance(got, list) else [got]
            wants = want if isinstance(want, list) else [want]
            torch.cuda.synchronize()
            # the store path hands back numpy, but the source rank of a
            # broadcast keeps its own tensor
            host = lambda v: v.cpu().numpy() if isinstance(
                v, torch.Tensor) else np.asarray(v)
            diff = max(float(np.abs(host(p) - host(w)).max())
                       for p, w in zip(parts, wants))
            out[op] = {"on_card": all(p.is_cuda for p in parts),
                       "in_place": got is t,
                       "equal_store": len(parts) == len(wants)
                       and diff == 0.0,
                       "max_abs_diff": diff}
    finally:
        col.destroy_collective_group("fit_nccl")
        col.destroy_collective_group("fit_store")
    return out


def _fit_loop(config):
    """The train loop of phase 20, run in the gang's worker (sent by value):
    phase 8's model, weights and batch, DDP over a mesh of the gang,
    ``config["steps"]`` steps from the checkpoint if there is one, each
    reported with the worker's launch counts, its calls of the kernels'
    plain versions (none may happen), its device and its times; a
    ``save_pytree`` checkpoint directory at the steps of
    ``config["ckpt_at"]``; a SIGKILL of itself at ``config["kill_at"]``
    when the marker file is not there yet (once per run), once the driver
    has registered the checkpoint before it (the ``config["ack"]`` file
    ``_recording`` writes): a report still on its way to the driver dies
    with the worker, and with it its checkpoint."""
    import os
    import signal
    import time as _time

    import torch as _torch
    import torch.distributed as dist

    from ray_tpu_torch import parallel, train
    from ray_tpu_torch._private import steptrace
    from ray_tpu_torch.air import Checkpoint, load_pytree, save_pytree
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools import train_runs

    t_loop = _time.time()
    attn.zero_launches()
    _torch.cuda.reset_peak_memory_stats()
    ctx = train.get_context()
    mesh = parallel.create_mesh({"data": ctx.get_world_size()})
    cfg = train_runs.bf16_config()
    model, opt = gpt2.make_train_state(cfg, _torch.Generator().manual_seed(0))
    model, opt = gpt2.shard_train_state(model, opt, mesh)
    start = 0
    ck = train.get_checkpoint()
    if ck is not None:
        with ck.as_directory() as d:
            load_pytree(d, model, "model")
            load_pytree(d, opt, "optimizer", model=model)
            with open(os.path.join(d, "step")) as f:
                start = int(f.read()) + 1
    step = gpt2.build_train_step(model, opt, mesh=mesh)
    batch = gpt2.shard_batch(gpt2.synthetic_batch(
        1, train_runs.BATCH, train_runs.SEQ, cfg.vocab_size), mesh)
    t_ready = _time.time()
    dev = _torch.cuda.current_device()
    nccl_ops = _nccl_collective_ops() if config.get("nccl_ops") else None
    with train_runs.counting_plain_calls() as plain_calls:
        for i in range(start, config["steps"]):
            if i == config.get("kill_at") and \
                    not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                deadline = _time.time() + 120
                while not os.path.exists(config["ack"]):
                    if _time.time() > deadline:
                        raise RuntimeError(
                            "the driver registered no checkpoint before "
                            f"step {i} in 120 s")
                    _time.sleep(0.05)
                os.kill(os.getpid(), signal.SIGKILL)
            t0 = _time.perf_counter()
            with train.step_phase("compute"):
                model, opt, loss = step(model, opt, batch)
            loss = float(loss)
            step_ms = (_time.perf_counter() - t0) * 1e3
            metrics = {
                "step": i, "loss": loss, "step_ms": step_ms,
                "pid": os.getpid(),
                "backend": dist.get_backend(), "world": dist.get_world_size(),
                "device": str(_torch.device("cuda", dev)),
                "device_name": _torch.cuda.get_device_name(dev),
                "launches": attn.read_launches(),
                "plain_calls": plain_calls[0],
                "peak_memory_bytes": _torch.cuda.max_memory_allocated(),
                "loop_start": t_loop, "ready": t_ready,
                "kernel_builds": sum(r["kind"] == "compile"
                                     for r in steptrace.snapshot()),
            }
            if nccl_ops is not None and i == start:
                metrics["nccl_ops"] = nccl_ops
            ckpt = None
            if i in config["ckpt_at"]:
                t0 = _time.perf_counter()
                d = os.path.join(config["ckpt_root"], f"step_{i}")
                save_pytree(model, d, "model")
                save_pytree(opt, d, "optimizer", model=model)
                if ctx.get_world_rank() == 0:
                    with open(os.path.join(d, "step"), "w") as f:
                        f.write(str(i))
                metrics["ckpt_s"] = _time.perf_counter() - t0
                metrics["ckpt_bytes"] = sum(
                    os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
                ckpt = Checkpoint.from_directory(d)
            train.report(metrics, checkpoint=ckpt)


@contextlib.contextmanager
def _timed_gang_start(times):
    """Appends (start s, process-group s) for every gang the executor
    starts: ``BackendExecutor.start`` (placement, the worker spawn,
    ``setup_session``) and within it the backend's ``on_start`` (the
    process group)."""
    from ray_tpu_torch.train import backend as backend_mod
    from ray_tpu_torch.train import backend_executor as be

    start, on_start = be.BackendExecutor.start, backend_mod._TorchBackend.on_start
    pg = []

    def timed_on_start(self, *a, **kw):
        t0 = time.perf_counter()
        on_start(self, *a, **kw)
        pg.append(time.perf_counter() - t0)

    def timed_start(self, *a, **kw):
        t0 = time.perf_counter()
        start(self, *a, **kw)
        total = time.perf_counter() - t0
        times.append((total - pg[-1], pg[-1]))

    be.BackendExecutor.start = timed_start
    backend_mod._TorchBackend.on_start = timed_on_start
    try:
        yield
    finally:
        be.BackendExecutor.start = start
        backend_mod._TorchBackend.on_start = on_start


def phase_train_fit(smi, bf16_losses, inproc_step_ms):
    """GPT-2-124M trained by ``TorchTrainer.fit()`` from a worker the
    port's raylet spawned, over NCCL: phase 8's run (``bf16_losses``, its
    in-process step ``inproc_step_ms``), then a SIGKILLed worker recovered
    at generation 1 from the step-1 checkpoint, and 2 steps with the int8
    gradient hook, at whose start the worker runs phase 36 (c)'s "nccl"
    ops (returned)."""
    import os
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.train.backend_executor import _ft_metrics
    from ray_tpu_torch.tools import train_runs

    if __name__ != "__main__":
        # imported by a short script: send the loop by value all the same
        import cloudpickle

        cloudpickle.register_pickle_by_value(sys.modules[__name__])
    root = tempfile.mkdtemp(prefix="train_fit_")
    t_init = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    init_s = time.perf_counter() - t_init
    session_dir = global_worker.node.session_dir
    _, restarts, recovery = _ft_metrics()
    r0 = restarts.default.value()
    h0 = recovery.default._series()
    gang_times, runs = [], {}

    def fit(name, steps, max_failures=0, mode="",
            ckpt_at=TRAIN_FIT["ckpt_at"], **extra):
        reports = []
        config = dict(steps=steps, ckpt_at=ckpt_at,
                      ckpt_root=os.path.join(root, "ckpt", name),
                      marker=os.path.join(root, f"{name}.killed"),
                      ack=os.path.join(root, f"{name}.ckpt_registered"),
                      **extra)
        trainer = train.TorchTrainer(
            _fit_loop, train_loop_config=config,
            torch_config=train.TorchConfig(ingraph_psum=mode),
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(
                name=name, storage_path=os.path.join(root, "results"),
                checkpoint_config=train.CheckpointConfig(num_to_keep=1),
                failure_config=train.FailureConfig(
                    max_failures=max_failures)))
        t0 = time.perf_counter()
        with _timed_gang_start(gang_times):
            trainer._fit_impl = _recording(trainer._fit_impl, reports,
                                           config["ack"])
            result = trainer.fit()
        if result.error is not None:
            raise AssertionError(f"train_fit {name}: {result.error}")
        runs[name] = {"reports": reports, "wall_s": time.perf_counter() - t0,
                      "config": config}
        return runs[name]

    try:
        steps = TRAIN_FIT["steps"]
        run3 = fit("recover", steps, max_failures=1,
                   kill_at=TRAIN_FIT["kill_at"])
        # each checkpoint is ~1.5 GB: keep none that no later run reads
        shutil.rmtree(os.path.join(root, "ckpt"))
        shutil.rmtree(os.path.join(root, "results"))
        run4 = fit("quantized", TRAIN_FIT["quant_steps"], mode="quantized",
                   ckpt_at=(), nccl_ops=True)
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    left = _wait_for_no_processes(session_dir)

    # one run: generation 0 takes steps 0-1 and the step-1 checkpoint and
    # is killed at step 2; generation 1 restores it and takes step 2
    rep1 = run3["reports"]
    killed_pid = rep1[0]["pid"]
    first_gen = [r for r in rep1 if r["pid"] == killed_pid]
    recovered = [r for r in rep1 if r["pid"] != killed_pid]
    losses = [r["loss"] for r in rep1]
    step_ms = [r["step_ms"] for r in rep1]
    # one sample: step 0 holds the warm-up, generation 1's holds the restore
    worker_ms = first_gen[1]["step_ms"]
    vs_phase8 = max(abs(a - b) for a, b in zip(losses, bf16_losses))
    quant = [r["loss"] for r in run4["reports"]]
    quant_ms = [r["step_ms"] for r in run4["reports"]]
    h1 = recovery.default._series()
    recovery_s = h1["sum"] - h0["sum"]
    ckpts = [r for run in runs.values() for r in run["reports"]
             if "ckpt_s" in r]
    card = smi.split(",")[0].strip()
    emit("train_fit", config="gpt2_124m attention=flash loss_chunks=8 "
         "bf16/f32-params AdamW, TorchTrainer(ScalingConfig(num_workers=1, "
         "use_gpu=True)), TorchConfig() -> NCCL, DDP at world size 1",
         batch=train_runs.BATCH, seq=train_runs.SEQ, init_s=init_s,
         worker_start_s=[g[0] for g in gang_times],
         process_group_s=[g[1] for g in gang_times],
         first_step_s=step_ms[0] / 1e3, worker_step_ms=worker_ms,
         worker_step_ms_each=step_ms, inproc_step_ms=inproc_step_ms,
         tokens_per_s=train_runs.BATCH * train_runs.SEQ / worker_ms * 1e3,
         losses=losses, phase8_losses=bf16_losses[:steps],
         max_loss_diff_vs_phase8=vs_phase8,
         recovered_losses=[r["loss"] for r in recovered],
         quantized_losses=quant, quantized_step_ms_each=quant_ms,
         quantized_vs_run1_step2_ms=[quant_ms[-1], step_ms[len(quant_ms) - 1]],
         train_recovery_seconds=recovery_s,
         restarts=restarts.default.value() - r0, killed_pid=killed_pid,
         ckpt_write_s=[r["ckpt_s"] for r in ckpts],
         ckpt_bytes=[r["ckpt_bytes"] for r in ckpts],
         peak_memory_bytes=max(r["peak_memory_bytes"] for r in rep1),
         kernel_builds_in_worker=rep1[-1]["kernel_builds"],
         launches={k: v["reports"][-1]["launches"] for k, v in runs.items()},
         first_generation_launches=first_gen[-1]["launches"],
         backend=rep1[0]["backend"], worker_pid=rep1[0]["pid"],
         driver_pid=os.getpid(), worker_device=rep1[0]["device"],
         worker_device_name=rep1[0]["device_name"],
         fit_wall_s={k: v["wall_s"] for k, v in runs.items()},
         processes_left=left,
         note="step ms on the worker's host clock around one step and its "
              "float(loss), worker_step_ms of generation 0's step 1; "
              "worker_start_s from placement to setup_session "
              "done, process_group_s the NCCL init after it; losses from "
              "phase 8's weights and batch, steps 0-1 from generation 0 "
              "and step 2 from the recovered generation 1")
    problems = []
    for name, run in runs.items():
        reps = run["reports"]
        if any(r["backend"] != "nccl" for r in reps):
            problems.append(f"{name}: backend {reps[0]['backend']}")
        if any(r["pid"] == os.getpid() for r in reps):
            problems.append(f"{name}: the loop ran in the driver's process")
        if any(r["device_name"] != card for r in reps):
            problems.append(f"{name}: worker device {reps[0]['device_name']}"
                            f" is not nvidia-smi's {card!r}")
        if any(r["plain_calls"] for r in reps):
            problems.append(f"{name}: the plain attention ran "
                            f"{reps[-1]['plain_calls']} times")
        last = [r for r in reps if r["pid"] == reps[-1]["pid"]]
        want = GPT2_124M["n_layer"] * len(last)
        if reps[-1]["launches"] != dict.fromkeys(KERNELS, want):
            problems.append(f"{name}: launches {reps[-1]['launches']}, "
                            f"want {want} each")
    if [r["step"] for r in rep1] != list(range(steps)):
        problems.append(f"fit reported steps {[r['step'] for r in rep1]}")
    if not (all(math.isfinite(x) for x in losses) and vs_phase8 <= 1e-2):
        problems.append(f"losses {losses} vs phase 8's {bf16_losses[:steps]}")
    want = dict.fromkeys(KERNELS, GPT2_124M["n_layer"] * len(first_gen))
    if first_gen[-1]["launches"] != want:
        problems.append(f"recover: generation 0's launches "
                        f"{first_gen[-1]['launches']}, want {want}")
    # the recovered step against phase 8's in-process run of the same
    # step (its uninterrupted counterpart, which it has equalled to the bit)
    rec_losses = [r["loss"] for r in recovered]
    if [r["step"] for r in recovered] != list(range(2, steps)) or \
            max(abs(a - b) for a, b in zip(rec_losses,
                                           bf16_losses[2:steps])) > 1e-3:
        problems.append(f"recover: {rec_losses} vs phase 8's "
                        f"{bf16_losses[2:steps]}")
    if restarts.default.value() != r0 + 1 or h1["count"] != h0["count"] + 1:
        problems.append(f"restarts {restarts.default.value() - r0}")
    if _alive(killed_pid):
        problems.append(f"the killed worker {killed_pid} is still alive")
    if len(quant) != TRAIN_FIT["quant_steps"] or \
            max(abs(a - b) for a, b in zip(quant, losses)) > 5e-2:
        problems.append(f"quantized: {quant} vs {losses[:len(quant)]}")
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    if problems:
        raise AssertionError("train_fit: " + "; ".join(problems))
    return run4["reports"][0]["nccl_ops"]


def _alive(pid):
    """Whether ``pid`` runs: a zombie (dead, its status not yet collected
    by a parent, which in a container may be an init that never reaps)
    does not."""
    try:
        with open(f"/proc/{pid}/status") as f:
            state = next(line for line in f if line.startswith("State:"))
    except (OSError, StopIteration):
        return False
    return "zombie" not in state


def _recording(fit_impl, reports, ack):
    """``_fit_impl`` with every rank-0 report's metrics appended to
    ``reports`` (the result callback the executor calls per report, after
    it has registered the report's checkpoint), and the file ``ack``
    written once a report that carried a checkpoint has been taken."""
    def wrapped(result_callback=None):
        def cb(metrics, checkpoint):
            reports.append(metrics)
            if result_callback:
                result_callback(metrics, checkpoint)
            if "ckpt_s" in metrics:
                with open(ack + ".tmp", "w") as f:
                    f.write(str(metrics["step"]))
                os.replace(ack + ".tmp", ack)
        return fit_impl(result_callback=cb)
    return wrapped


# Phase 21: Tune's ASHA over the lr of ViT-B/16 trials, four at a time on
# the card: a wave of four and a fifth trial. Two rates of the wave barely
# move the loss, yet the four may reach each rung worst first, and then
# ASHA rightly stops none of them. The fifth, the grid's lowest lr and so
# its highest loss at the first rung, starts only when one of the four
# ends: the first rung then holds results of the wave, so ASHA stops it
# there whatever their order. 1e-4 is phase 13's lr.
TUNE_ASHA = {"lrs": (1e-4, 1e-3, 3e-6, 1e-7, 1e-8),
             "max_t": 8, "grace_period": 2, "reduction_factor": 2,
             "concurrent": 4, "gpu": 0.25, "phase13_lr": 1e-4,
             "vs_phase13_steps": 5, "vs_phase13_limit": 1e-2}


def _max_overlap(spans):
    """The most of the (start, end) spans that hold one instant."""
    edges = sorted([(s, 1) for s, _ in spans] + [(e, -1) for _, e in spans])
    most = now = 0
    for _, step in edges:
        now += step
        most = max(most, now)
    return most


def phase_tune_asha(smi, vit_losses, vit_step_ms):
    """``Tuner(TorchTrainer(tune_runs.vit_trial_loop)).fit()``: ASHA over
    the lr of 5 ViT-B/16 trials at full width, each a gang of one worker
    leasing a quarter of the card, 4 at a time (phase 13's weights, batch
    and model; ``vit_losses`` and ``vit_step_ms`` are phase 13's)."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.tools import tune_runs
    from ray_tpu_torch.util import state

    cfg = TUNE_ASHA
    asha = {k: cfg[k] for k in ("max_t", "grace_period", "reduction_factor")}
    root = tempfile.mkdtemp(prefix="tune_asha_")
    t_init = time.perf_counter()
    rt.init(num_cpus=cfg["concurrent"], num_gpus=1)
    init_s = time.perf_counter() - t_init
    session_dir = global_worker.node.session_dir
    try:
        tuner, scheduler = tune_runs.asha_tuner(
            cfg["lrs"], tune_runs.LOOP, **asha,
            max_concurrent_trials=cfg["concurrent"],
            resources_per_worker={"CPU": 1, "GPU": cfg["gpu"]},
            storage_path=os.path.join(root, "results"))
        t0 = time.perf_counter()
        grid = tuner.fit()
        wall_s = time.perf_counter() - t0
        best = grid.get_best_result().metrics
        errors = [str(e) for e in grid.errors]
        # a failed trial's actors as the GCS recorded their end
        deaths = sorted({a["death_cause"] for a in state.list_actors()
                         if a["state"] == "DEAD" and a["death_cause"]}) \
            if errors else []
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    left = _wait_for_no_processes(session_dir)

    lr_of = {tid: c["train_loop_config"]["lr"]
             for tid, c in scheduler.configs.items()}
    reports = {lr_of[tid]: rows for tid, rows in scheduler.results.items()}
    stopped = {lr_of[tid]: t
               for tid, t in tune_runs.stopped_early(scheduler).items()}
    replayed = tune_runs.replay(scheduler.events, scheduler.trial_ids,
                                metric="loss", mode="min", **asha)
    decided = [e[4] for e in scheduler.events if e[0] == "result"]
    trials, launches = [], dict.fromkeys(KERNELS, 0)
    for lr, rows in reports.items():
        last = rows[-1]
        for name in KERNELS:
            launches[name] += last["launches"][name]
        step_ms = [r["step_ms"] for r in rows]
        trials.append({
            "lr": lr, "iterations": last["training_iteration"],
            "stop_rung": stopped.get(lr),
            "losses": [r["loss"] for r in rows],
            "worker_start_to_loop_s": (last["loop_start"]
                                       - last["worker_start"]),
            "context_s": last["context"] - last["loop_start"],
            "model_built_s": last["built"] - last["context"],
            "batch_ready_s": last["ready"] - last["built"],
            "cpu_threads": last["cpu_threads"],
            "first_step_s": step_ms[0] / 1e3,
            "step_ms_median_after_first": (statistics.median(step_ms[1:])
                                           if len(step_ms) > 1 else None),
            "step_ms": step_ms,
            "peak_memory_bytes": last["peak_memory_bytes"],
            "launches": last["launches"], "plain_calls": last["plain_calls"],
            "kernel_builds": last["kernel_builds"], "pid": last["pid"],
            "device_name": last["device_name"],
            "span": [last["loop_start"], last["reported_at"]]})
    trials.sort(key=lambda t: t["span"][0])
    overlap = _max_overlap([t["span"] for t in trials])
    record = [{"rung": e[5], "lr": lr_of[e[1]], "t": e[2], "loss": e[3],
               "cutoff": e[6], "decision": e[4]}
              for e in scheduler.events if e[0] == "result" and e[5]]
    ref = reports.get(cfg["phase13_lr"], [])
    ref_losses = [r["loss"] for r in ref[:cfg["vs_phase13_steps"]]]
    vs13 = [abs(a - b) for a, b in zip(ref_losses, vit_losses)]
    lowest = min(trials, key=lambda t: t["losses"][-1])
    card = smi.split(",")[0].strip()
    emit("tune_asha_vit", config="vit_b16 bf16/f32-params AdamW, Tuner("
         "TorchTrainer(ScalingConfig(num_workers=1, resources_per_worker="
         f"{{'CPU': 1, 'GPU': {cfg['gpu']}}})), ASHA(max_t={cfg['max_t']}, "
         f"grace_period={cfg['grace_period']}, reduction_factor="
         f"{cfg['reduction_factor']}), max_concurrent_trials="
         f"{cfg['concurrent']})", lrs=list(cfg["lrs"]), init_s=init_s,
         tuner_wall_s=wall_s, trials=trials, max_trials_at_once=overlap,
         phase13_step_ms=vit_step_ms, phase13_losses=vit_losses,
         lr_1e4_losses=ref_losses, max_loss_diff_vs_phase13=max(vs13 or [0]),
         lr_1e4_equal_to_phase13_bits=ref_losses == list(
             vit_losses[:len(ref_losses)]),
         asha_record=record, stopped_early=stopped,
         replay_equal=replayed == decided,
         best_lr=best["config"]["train_loop_config"]["lr"],
         lowest_last_loss_lr=lowest["lr"], launches=launches,
         errors=errors, dead_actor_causes=deaths, processes_left=left,
         note="step ms on each worker's host clock around one step and its "
              "float(loss), 4 trials sharing the card; worker_start_to_loop "
              "covers the worker's spawn, torch's import and the NCCL "
              "process group")
    n_layer = tune_runs.MODELS[tune_runs.LOOP["model"]]().n_layer
    problems = []
    if errors or len(trials) != len(cfg["lrs"]):
        problems.append(f"{len(trials)} trials, errors {errors}, dead "
                        f"actors' causes {deaths}")
    for t in trials:
        want = dict.fromkeys(KERNELS, n_layer * t["iterations"])
        if t["launches"] != want:
            problems.append(f"lr {t['lr']}: launches {t['launches']}, "
                            f"want {want}")
        if t["plain_calls"]:
            problems.append(f"lr {t['lr']}: {t['plain_calls']} plain calls")
        if t["kernel_builds"]:
            problems.append(f"lr {t['lr']}: a kernel build in the worker: "
                            f"{t['kernel_builds']}")
        if t["device_name"] != card:
            problems.append(f"lr {t['lr']}: device {t['device_name']}")
        if not all(math.isfinite(x) for x in t["losses"]):
            problems.append(f"lr {t['lr']}: losses {t['losses']}")
    if len(ref_losses) != cfg["vs_phase13_steps"] or \
            max(vs13) > cfg["vs_phase13_limit"]:
        problems.append(f"lr {cfg['phase13_lr']}: {ref_losses} vs phase "
                        f"13's {vit_losses}")
    if not stopped:
        problems.append("ASHA stopped no trial before max_t")
    if stopped.get(cfg["lrs"][-1]) != cfg["grace_period"]:
        problems.append(f"ASHA stopped the last lr {cfg['lrs'][-1]} at "
                        f"{stopped.get(cfg['lrs'][-1])}, not at the first "
                        f"rung {cfg['grace_period']}")
    if replayed != decided:
        problems.append(f"ASHA decided {decided}, a replay {replayed}")
    if best["config"]["train_loop_config"]["lr"] != lowest["lr"]:
        problems.append(f"best lr {best['config']} is not the lowest last "
                        f"loss's {lowest['lr']}")
    if overlap != cfg["concurrent"]:
        problems.append(f"{overlap} trials ran at once, want "
                        f"{cfg['concurrent']}")
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    if problems:
        raise AssertionError("tune_asha_vit: " + "; ".join(problems))
    return launches


def _tune_entries(vit_entries, launches):
    """The ``kernels`` line's rows of the ViT-in-a-trial path: phase 15's
    entries at ViT-B/16's shape (the times taken in this process) with the
    launches the trials' workers counted."""
    rows = []
    for entry in vit_entries:
        row = dict(entry, path="tune_vit_trial",
                   launches=launches[entry["name"]])
        row["note"] = ("launches summed over the trials' workers; times are "
                       "phase 15's at this shape in the driver's process")
        rows.append(row)
    return rows


# phase 22: phase 14's run (``data_runs.LOOP``) in a ``TorchTrainer``
# worker, fed by the port's Data: 5 epochs of phase 14's batch, then one
# epoch of a CIFAR-10-sized training set (50,000 images of 32^2 in 10
# classes, from numpy seed 51) in blocks of 1,000 rows, batch 256 with
# drop_last (195 steps)
DATA_FIT = {"train_rows": 50_000, "block_rows": 1_000, "train_seed": 51,
            "parity_epochs": 5, "vs_phase14_limit": 1e-2}


def _spread(xs):
    """Mean, median, p90, max and sum of a list of ms."""
    xs = sorted(xs)
    return {"mean": statistics.fmean(xs), "median": statistics.median(xs),
            "p90": xs[int(0.9 * (len(xs) - 1))], "max": xs[-1],
            "sum": sum(xs)}


def phase_data_resnet_fit(smi, resnet_losses, resnet_images_per_s):
    """"TorchTrainer: ResNet-50 on CIFAR-10" through Data:
    ``TorchTrainer(data_runs.resnet_data_loop, datasets={"parity", "train"})``
    with one worker on the card, reading its shards through
    ``iter_torch_batches(device=...)``. ``resnet_losses`` and
    ``resnet_images_per_s`` are phase 14's."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.models import vision
    from ray_tpu_torch.tools import data_runs

    cfg = vision.ResNetConfig.resnet50_cifar()
    batch = data_runs.LOOP["batch"]
    t0 = time.perf_counter()
    parity = dict(zip(("image", "label"), data_runs.image_arrays(
        50, RESNET["batch"], cfg.image_size, cfg.num_classes)))
    train_set = dict(zip(("image", "label"), data_runs.image_arrays(
        DATA_FIT["train_seed"], DATA_FIT["train_rows"], cfg.image_size,
        cfg.num_classes)))
    make_s = time.perf_counter() - t0
    train_bytes = sum(v.nbytes for v in train_set.values())
    root = tempfile.mkdtemp(prefix="data_fit_")
    t_init = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    init_s = time.perf_counter() - t_init
    session_dir = global_worker.node.session_dir
    try:
        t0 = time.perf_counter()
        datasets = {
            "parity": data_runs.image_dataset(parity, RESNET["batch"]),
            "train": data_runs.image_dataset(train_set,
                                             DATA_FIT["block_rows"])}
        put_s = time.perf_counter() - t0
        del train_set
        blocks = {k: v.num_blocks() for k, v in datasets.items()}
        config = dict(data_runs.LOOP, epochs=(
            ("parity", DATA_FIT["parity_epochs"]), ("train", 1)))
        trainer = train.TorchTrainer(
            data_runs.resnet_data_loop, train_loop_config=config,
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(
                name="data_fit", storage_path=os.path.join(root, "results")),
            datasets=datasets)
        t0 = time.perf_counter()
        result = trainer.fit()
        fit_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    left = _wait_for_no_processes(session_dir)
    if result.error is not None:
        raise AssertionError(f"data_resnet_fit: {result.error}")
    m = result.metrics
    par, ep = m["datasets"]["parity"], m["datasets"]["train"]
    vs14 = [abs(a - b) for a, b in zip(par["losses"], resnet_losses)]
    want_rows = DATA_FIT["train_rows"] // batch * batch
    emit("data_resnet_fit", config="resnet50_cifar bf16/f32-params AdamW "
         "lr 1e-4, TorchTrainer(ScalingConfig(num_workers=1, use_gpu=True), "
         "datasets={parity, train}), iter_torch_batches(batch_size=256, "
         "device=cuda:local_rank, drop_last=True)",
         train_rows=DATA_FIT["train_rows"], train_bytes=train_bytes,
         blocks=blocks, make_s=make_s, put_s=put_s, init_s=init_s,
         fit_wall_s=fit_s, parity_losses=par["losses"],
         phase14_losses=resnet_losses,
         max_loss_diff_vs_phase14=max(vs14 or [0]),
         parity_equal_to_phase14_bits=par["losses"] == list(resnet_losses),
         parity_epoch_s=par["epoch_s"], epoch_rows=ep["rows"],
         epoch_steps=len(ep["losses"]), epoch_s=ep["epoch_s"][0],
         epoch_images_per_s=ep["images_per_s"][0],
         phase14_images_per_s=resnet_images_per_s,
         first_batch_wait_s={"parity": par["first_batch_wait_s"],
                             "train": ep["first_batch_wait_s"][0]},
         epoch_losses_first_last=[ep["losses"][0], ep["losses"][-1]],
         epoch_wait_ms=_spread(ep["wait_ms"]),
         epoch_step_ms=_spread(ep["step_ms"]),
         parity_step_ms=par["step_ms"], parity_wait_ms=par["wait_ms"],
         phase14_step_ms=batch / resnet_images_per_s * 1e3,
         peak_memory_bytes=m["peak_memory_bytes"], launches=m["launches"],
         plain_calls=m["plain_calls"], device_name=m["device_name"],
         processes_left=left,
         note="epoch wall on the worker's host clock from the shard's "
              "iterator to its last step (each step ends in float(loss)); "
              "phase 14's images/s is its median step's, in this process")
    problems = []
    if len(par["losses"]) != DATA_FIT["parity_epochs"] or \
            max(vs14) > DATA_FIT["vs_phase14_limit"]:
        problems.append(f"parity losses {par['losses']} vs phase 14's "
                        f"{resnet_losses}")
    if ep["rows"] != want_rows or len(ep["losses"]) != want_rows // batch:
        problems.append(f"the epoch saw {ep['rows']} rows in "
                        f"{len(ep['losses'])} steps, want {want_rows}")
    if not all(math.isfinite(x) for x in par["losses"] + ep["losses"]):
        problems.append("non-finite loss")
    if any(m["launches"].values()) or m["plain_calls"]:
        problems.append(f"flash kernels launched: {m['launches']}, plain "
                        f"calls {m['plain_calls']}")
    if m["device_name"] != smi.split(",")[0].strip():
        problems.append(f"worker on {m['device_name']}")
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    if problems:
        raise AssertionError("data_resnet_fit: " + "; ".join(problems))


# phase 23: ViT-B/16 (phase 13's seed-0 weights) scored over 1,024 images
# of 224^2 from numpy seed 60 in 16 blocks of 64, batch 64, by two
# actors at one CPU each (the reference's defaults)
PREDICT = {"rows": 1024, "block_rows": 64, "seed": 60, "batch": 64,
           "concurrency": 2, "num_cpus": 1}


def _probed_torch_predictor():
    """``TorchPredictor`` that takes an ``id`` column beside the images
    and hands it back beside ``predictions``, with what its actor counted
    while it scored the batch: ``flash_fwd`` and backward launches and
    plain-version calls, when it began the batch (wall clock) and the ms
    of ``TorchPredictor.predict`` on it (in the batch's first row, 0 in the
    others); its pid, the seconds from its process's start to its model on
    the card, ``from_checkpoint``'s part of them, and its peak card memory.
    Built in a function, so the class travels to the actors by value."""
    from ray_tpu_torch.train.predictor import TorchPredictor

    class ProbedTorchPredictor(TorchPredictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, device=None, **kw):
            from ray_tpu_torch.tools.tune_runs import _process_start

            t0 = time.time()
            inst = super().from_checkpoint(checkpoint, device=device, **kw)
            torch.cuda.synchronize(inst._device)
            inst.load_s = time.time() - t0
            inst.start_s = time.time() - _process_start()
            return inst

        def predict(self, batch):
            import os as _os

            from ray_tpu_torch.ops import attention as attn
            from ray_tpu_torch.tools.train_runs import counting_plain_calls

            ids = batch.pop("id")
            before = attn.read_launches()
            began = time.time()
            t0 = time.perf_counter()
            with counting_plain_calls() as plain:
                out = super().predict(batch)
            predict_ms = (time.perf_counter() - t0) * 1e3
            n = len(ids)
            first = np.zeros(n, np.int64)
            for name in KERNELS:
                out[name] = first.copy()
                out[name][0] = attn.read_launches()[name] - before[name]
            out["plain_calls"] = first.copy()
            out["plain_calls"][0] = plain[0]
            out["began"] = np.zeros(n)
            out["began"][0] = began
            out["predict_ms"] = np.zeros(n)
            out["predict_ms"][0] = predict_ms
            out["id"] = ids
            out["pid"] = np.full(n, _os.getpid())
            out["start_s"] = np.full(n, self.start_s)
            out["load_s"] = np.full(n, self.load_s)
            out["peak_memory_bytes"] = np.full(
                n, torch.cuda.max_memory_allocated(self._device))
            out["device_name"] = np.array(
                [torch.cuda.get_device_name(self._device)] * n, object)
            return out

    return ProbedTorchPredictor


def phase_batch_predict_vit(smi):
    """``BatchPredictor.from_checkpoint(TorchPredictor.pack(ViT-B/16),
    ProbedTorchPredictor).predict(ds)``: two ``map_batches`` actors score
    the set on the card through ``flash_fwd`` (non-causal, B*H 768, S 197,
    D 64; 12 launches a batch); the logits against the driver's own
    forward of the same model, weights and images in the same batches.
    Returns the actors' summed launches."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.models import vision
    from ray_tpu_torch.tools import data_runs, vision_runs
    from ray_tpu_torch.train.predictor import BatchPredictor, TorchPredictor

    if __name__ != "__main__":
        # imported by a short script: send the predictor by value all the
        # same
        import cloudpickle

        cloudpickle.register_pickle_by_value(sys.modules[__name__])
    cfg = vision.ViTConfig.vit_b16()
    net = vision_runs.model(cfg, "cuda")
    ck = TorchPredictor.pack(net)
    cols = data_runs.vit_image_columns(PREDICT["seed"], PREDICT["rows"],
                                       cfg.image_size)
    root = tempfile.mkdtemp(prefix="batch_predict_")
    t_init = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    init_s = time.perf_counter() - t_init
    session_dir = global_worker.node.session_dir
    batches, arrivals = [], []
    try:
        ds = data_runs.image_dataset(cols, PREDICT["block_rows"])
        bp = BatchPredictor.from_checkpoint(ck, _probed_torch_predictor())
        t0 = time.perf_counter()
        scored = bp.predict(ds, batch_size=PREDICT["batch"],
                            concurrency=PREDICT["concurrency"],
                            num_cpus=PREDICT["num_cpus"])
        for out in scored.iter_batches(batch_size=None):
            arrivals.append(time.perf_counter() - t0)
            batches.append(out)
        split = _predict_split(net, [rt.get(ref) for ref, _ in ds._bundles()])
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    left = _wait_for_no_processes(session_dir)
    got = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    order = np.argsort(got["id"], kind="stable")
    logits = torch.from_numpy(got["predictions"][order])

    # the driver's forward: the same model, weights and images in the same
    # batches of 64; the second pass is timed
    data_runs.batched_logits(net, cols["image"], PREDICT["batch"], "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = torch.from_numpy(data_runs.batched_logits(
        net, cols["image"], PREDICT["batch"], "cuda"))
    inproc_s = time.perf_counter() - t0
    del net
    torch.cuda.empty_cache()
    ok, err, share = _close(logits, want, *TOLS[torch.bfloat16])
    argmax_equal = bool((logits.argmax(-1) == want.argmax(-1)).all())
    launches = {n: int(got[n].sum()) for n in KERNELS}
    actors = {}
    for pid in sorted(set(got["pid"].tolist())):
        rows = got["pid"] == pid
        heads = rows & (got["began"] > 0)
        began = np.sort(got["began"][heads])
        actors[pid] = {"rows": int(rows.sum()),
                       "predict_ms": got["predict_ms"][heads].tolist(),
                       "predict_ms_median": float(np.median(
                           got["predict_ms"][heads])),
                       "batch_interval_ms_median": float(np.median(
                           np.diff(began))) * 1e3 if len(began) > 1
                       else None,
                       "start_s": float(got["start_s"][rows][0]),
                       "load_s": float(got["load_s"][rows][0]),
                       "peak_memory_bytes": int(
                           got["peak_memory_bytes"][rows].max()),
                       "device_name": got["device_name"][rows][0]}
    n = PREDICT["rows"]
    steady = (len(batches) - 1) * PREDICT["batch"] / \
        (arrivals[-1] - arrivals[0]) if len(batches) > 1 else None
    emit("batch_predict_vit", config="vit_b16 bf16/f32-params, "
         "BatchPredictor(TorchPredictor).predict(batch_size=64, "
         "concurrency=2, num_cpus=1)", rows=n,
         image_bytes=cols["image"].nbytes, blocks=ds.num_blocks(),
         init_s=init_s, predict_wall_s=arrivals[-1],
         images_per_s=n / arrivals[-1],
         first_batch_s=arrivals[0], steady_images_per_s=steady,
         inproc_s=inproc_s, inproc_images_per_s=n / inproc_s,
         max_abs_err=err, share_of_limit=share,
         tolerance=_tol_fields(torch.bfloat16),
         equal_to_inproc_bits=bool(torch.equal(logits, want)),
         argmax_equal=argmax_equal, launches=launches,
         driver_predict_split_ms=split,
         plain_calls=int(got["plain_calls"].sum()), actors=actors,
         processes_left=left,
         note="predict wall on the driver's host clock from predict() to "
              "the last scored block; steady from the first block's "
              "arrival to the last's; the in-process forward's second "
              "pass, to a sync")
    problems = []
    if sorted(got["id"].tolist()) != list(range(n)):
        problems.append("ids missing or repeated")
    if got["predictions"].shape != (n, cfg.num_classes):
        problems.append(f"predictions {got['predictions'].shape}")
    if not ok or not argmax_equal:
        problems.append(f"logits vs in-process: max abs err {err}, share "
                        f"{share}, argmax equal {argmax_equal}")
    want_launches = cfg.n_layer * n // PREDICT["batch"]
    if launches != {"flash_fwd": want_launches, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0}:
        problems.append(f"launches {launches}, want flash_fwd "
                        f"{want_launches} and no backward")
    if int(got["plain_calls"].sum()):
        problems.append(f"{int(got['plain_calls'].sum())} plain calls")
    card = smi.split(",")[0].strip()
    if len(actors) != PREDICT["concurrency"] or any(
            a["device_name"] != card for a in actors.values()):
        problems.append(f"actors {actors}")
    if os.getpid() in actors:
        problems.append("scored in the driver's process")
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    if problems:
        raise AssertionError("batch_predict_vit: " + "; ".join(problems))
    return launches


def _predict_split(net, blocks):
    """Medians over ``blocks`` (read back from the object store, as an actor
    gets them) of the ms of each part of ``TorchPredictor.predict``, run
    in this process, each part to a sync: the feature matrix, ``astype``,
    the copy to the card, the forward, the copy back."""
    from ray_tpu_torch.train.predictor import _as_feature_matrix

    parts = {k: [] for k in ("feature_matrix", "astype", "to_device",
                             "forward", "to_host")}
    dev = next(net.parameters()).device
    with torch.inference_mode():
        for block in blocks:
            t = [time.perf_counter()]
            x = _as_feature_matrix({"image": block["image"]})
            t.append(time.perf_counter())
            x = x.astype(np.float32)
            t.append(time.perf_counter())
            x = torch.from_numpy(x).to(dev)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            y = net(x)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            y.cpu().numpy()
            t.append(time.perf_counter())
            for k, a, b in zip(parts, t, t[1:]):
                parts[k].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def _predict_entries(vit_entries, launches):
    """The ``kernels`` line's row of the batch-prediction path: phase 15's
    ``flash_fwd`` entry at ViT-B/16's shape (forward only) with the
    launches the predictor's actors counted."""
    return [dict(entry, path="batch_predict_vit",
                 launches=launches[entry["name"]],
                 note="launches summed over the predictor's actors; times "
                      "are phase 15's at this shape in the driver's "
                      "process")
            for entry in vit_entries if entry["name"] == "flash_fwd"]


# phases 24-25: RLlib's tuned examples as the repo ships them, the learner
# on the card and the env runners on CPUs; the bar and the iteration budget
# are each yaml's own stop block. The CUDA-vs-CPU check of phase 24 runs
# ``PPOLearner.update`` on one batch of ``cuda_cpu_rows`` rows from numpy
# seed 70 with the trained weights; phase 25 times v-trace on a fragment of
# ``vtrace_rows`` from numpy seed 71.
RLLIB = {"ppo": "cartpole-ppo", "impala": "cartpole-impala-multilearner",
         "cuda_cpu_rows": 512, "cuda_cpu_seed": 70, "rtol": 1e-5,
         "atol": 1e-6, "vtrace_rows": 256, "vtrace_seed": 71}


def _tuned_example(name):
    from ray_tpu_torch.rllib.run_regression import (
        TUNED_EXAMPLES_DIR,
        load_experiments,
    )

    return load_experiments(TUNED_EXAMPLES_DIR, name)[name]


def _timed_method(obj, name, log):
    """Wrap ``obj.name`` so each call appends its host seconds and what it
    returned to ``log``."""
    inner = getattr(obj, name)

    def timed(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        log.append({"s": time.perf_counter() - t0, "out": out})
        return out

    setattr(obj, name, timed)


def _train_to_bar(algo, stop):
    """``algo.train()`` until ``episode_return_mean`` reaches the yaml's bar
    or its iteration budget is spent: (iterations, best, returns, host
    seconds of each ``train()``)."""
    best, returns, iter_s = float("-inf"), [], []
    for it in range(1, stop["training_iteration"] + 1):
        t0 = time.perf_counter()
        result = algo.train()
        iter_s.append(time.perf_counter() - t0)
        returns.append(result.get("episode_return_mean"))
        if returns[-1] is not None:
            best = max(best, returns[-1])
        if best >= stop["episode_return_mean"]:
            break
    return it, best, returns, iter_s


def _steady_rate(samples, iter_s):
    """Env steps a second after the first iteration (which starts the
    runners' processes and the learner's CUDA work)."""
    return sum(f.count for s in samples[1:] for f in s["out"]) / \
        sum(iter_s[1:]) if len(iter_s) > 1 else None


def _rows(samples):
    """Rows of every fragment that ``Algorithm._sample_all`` returned."""
    return sum(f.count for s in samples for f in s["out"])


def _card_fds(pid):
    """How many of ``pid``'s open files are the card's device nodes
    (``/dev/nvidia*``): a process with a CUDA context holds some. (Where
    ``nvidia-smi`` lists no process, as in a container, ``_card_memory_of``
    cannot tell.)"""
    n = 0
    for fd in os.listdir(f"/proc/{pid}/fd"):
        with contextlib.suppress(OSError):
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
    return n


def _on_card(session_dir, allowed):
    """Session processes other than ``allowed`` that have the card open:
    {pid: its open files on the card}."""
    from ray_tpu_torch.tools.cluster_runs import session_processes

    return {pid: n for pid in session_processes(session_dir)
            if pid not in allowed and (n := _card_fds(pid))}


def _ppo_batch(rows, seed):
    """A PPO train batch (CartPole's shapes) from numpy ``seed``."""
    from ray_tpu_torch.rllib.sample_batch import SampleBatch

    rng = np.random.default_rng(seed)
    return SampleBatch({
        "obs": rng.normal(size=(rows, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, rows).astype(np.int32),
        "logp": np.log(rng.uniform(0.2, 0.8, rows)).astype(np.float32),
        "advantages": rng.normal(size=rows).astype(np.float32),
        "value_targets": rng.normal(5.0, 3.0, rows).astype(np.float32)})


def _cuda_vs_cpu_update(config, weights):
    """One ``PPOLearner.update`` of the same weights on the same batch, on
    the card and on the CPU: (max abs error of the metrics, of the weights,
    whether both agree at the stated tolerance, whether to the bit)."""
    from ray_tpu_torch.rllib.learner import PPOLearner
    from ray_tpu_torch.rllib.rl_module import RLModule

    batch = _ppo_batch(RLLIB["cuda_cpu_rows"], RLLIB["cuda_cpu_seed"])
    out = {}
    for dev in ("cuda", "cpu"):
        module = RLModule((4,), 2, seed=0, device=dev,
                          hiddens=config.model["hiddens"])
        module.set_state(weights)
        learner = PPOLearner(module, config)
        metrics = learner.update(batch)
        out[dev] = (metrics, module.get_state())
    (m_gpu, w_gpu), (m_cpu, w_cpu) = out["cuda"], out["cpu"]
    rtol, atol = RLLIB["rtol"], RLLIB["atol"]
    metric_err = max(abs(m_gpu[k] - m_cpu[k]) for k in m_cpu)
    weight_err = max(float(np.abs(w_gpu[k] - w_cpu[k]).max()) for k in w_cpu)
    close = all(np.allclose(m_gpu[k], m_cpu[k], rtol=rtol, atol=atol)
                for k in m_cpu) and all(
        np.allclose(w_gpu[k], w_cpu[k], rtol=rtol, atol=atol) for k in w_cpu)
    bits = m_gpu == m_cpu and all(np.array_equal(w_gpu[k], w_cpu[k])
                                  for k in w_cpu)
    return {"metrics_max_abs_err": metric_err,
            "weights_max_abs_err": weight_err, "rtol": rtol, "atol": atol,
            "agree": close, "equal_bits": bits,
            "rows": RLLIB["cuda_cpu_rows"],
            "adam_steps": config.num_epochs * (
                RLLIB["cuda_cpu_rows"] // config.minibatch_size)}


def _update_profile(learner, batch):
    """One ``learner.update(batch)`` on the card: its ms by CUDA events
    (median of 3; the update ends in a host read of its metrics), then
    under the profiler, over one more call, its kernels' busy ms and
    launches, and the idle share of the events' span."""
    from ray_tpu_torch.tools import timing

    spans = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        learner.update(batch)
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    by_kernel, launches = timing.kernel_ms(lambda: learner.update(batch), 1)
    busy = sum(by_kernel.values())
    event_ms = statistics.median(spans)
    return {"event_ms": event_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / event_ms, "launches": launches,
            "top_kernels_ms": dict(list(by_kernel.items())[:5])}


def phase_rllib_ppo(smi):
    """``cartpole-ppo`` as the repo ships it: ``PPOConfig`` built by
    ``run_regression.build_algorithm``, 2 env runners on CPUs, fragments
    of 256, lr 5e-3, 6 epochs of minibatches of 128, seed 0, the learner
    in the driver on the card (``num_gpus_per_learner`` 1, the default)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.rllib.run_regression import build_algorithm

    spec = _tuned_example(RLLIB["ppo"])
    stop = spec["stop"]
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    init_s = time.perf_counter() - t0
    session_dir = global_worker.node.session_dir
    samples, updates = [], []
    try:
        t0 = time.perf_counter()
        algo = build_algorithm(spec)
        build_s = time.perf_counter() - t0
        learner = algo.learner
        _timed_method(algo, "_sample_all", samples)
        _timed_method(learner, "update", updates)
        attn.zero_launches()
        iters, best, returns, iter_s = _train_to_bar(algo, stop)
        update_s = [u["s"] for u in updates]  # the training's, not below
        flash = attn.read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        param_devices = sorted({str(p.device) for p in learner.params})
        state_devices = sorted({str(v.device) for s in
                                learner.optimizer.state.values()
                                for v in s.values() if torch.is_tensor(v)
                                and v.dim() > 0})
        on_card = _on_card(session_dir, ())
        driver_fds = _card_fds(os.getpid())
        timesteps = algo._timesteps
        weights = learner.get_weights()
        from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae

        cfg = algo.config
        batch = SampleBatch.concat([
            compute_gae(f, float(f["bootstrap_value"][-1]), cfg.gamma,
                        cfg.lambda_) for f in samples[-1]["out"]])
        profile = _update_profile(learner, batch)
        cuda_cpu = _cuda_vs_cpu_update(cfg, weights)
    finally:
        try:
            algo.stop()
        finally:
            rt.shutdown()
    left = _wait_for_no_processes(session_dir)
    train_s = sum(iter_s)
    emit("rllib_ppo", config=f"{RLLIB['ppo']} (ray_tpu_torch/rllib/"
         "tuned_examples): PPO, 2 CPU env runners, fragments of 256, lr "
         "5e-3, 6 epochs x minibatch 128, seed 0, learner in the driver on "
         "the card", bar=stop["episode_return_mean"],
         budget=stop["training_iteration"], iterations=iters, best=best,
         returns=returns, timesteps=timesteps,
         env_steps_per_s=timesteps / train_s, train_s=train_s,
         init_s=init_s, build_s=build_s, iteration_s=iter_s,
         steady_env_steps_per_s=_steady_rate(samples, iter_s),
         sample_s=[s["s"] for s in samples], update_s=update_s,
         update_profile=profile, learner_peak_memory_bytes=peak,
         param_devices=param_devices, adam_state_devices=state_devices,
         session_processes_on_card=on_card,
         driver_card_fds=driver_fds, flash_launches=flash,
         cuda_vs_cpu_update=cuda_cpu, processes_left=left,
         device_name=torch.cuda.get_device_name(dev), nvidia_smi=smi,
         note="host clock around algo.train(), Algorithm._sample_all and "
              "learner.update (which ends in a host read of its metrics); "
              "update_profile on the last iteration's batch after the run")
    problems = []
    if best < stop["episode_return_mean"]:
        problems.append(f"best {best} below the bar in {iters} iterations")
    if param_devices != [str(dev)] or state_devices != [str(dev)]:
        problems.append(f"learner on {param_devices}, Adam state on "
                        f"{state_devices}")
    if on_card or not driver_fds:
        problems.append(f"session processes on the card: {on_card}; the "
                        f"driver's open files on it: {driver_fds}")
    if not cuda_cpu["agree"]:
        problems.append(f"CUDA vs CPU update: {cuda_cpu}")
    if any(flash.values()):
        problems.append(f"flash kernels launched: {flash}")
    if timesteps != _rows(samples):
        problems.append(f"timesteps {timesteps} vs sampled {_rows(samples)}")
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    if problems:
        raise AssertionError("rllib_ppo: " + "; ".join(problems))


def _vtrace_profile():
    """v-trace over one fragment on the card (the IMPALA learner's loop, one
    ``addcmul`` launch a step): ms by CUDA events, kernels' busy ms and
    launches per call from the profiler, and the same loop's host ms on
    the CPU."""
    from ray_tpu_torch.rllib.learner import vtrace
    from ray_tpu_torch.tools import timing

    n = RLLIB["vtrace_rows"]
    rng = np.random.default_rng(RLLIB["vtrace_seed"])
    cols = [np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
            np.log(rng.uniform(0.2, 0.8, n)).astype(np.float32),
            np.ones(n, np.float32), rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32), rng.uniform(size=n) < 0.02,
            rng.uniform(size=n) < 0.01]
    on = {d: [torch.from_numpy(c).to(d) for c in cols] for d in
          ("cuda", "cpu")}
    got = [t.cpu() for t in vtrace(*on["cuda"], 0.99)]
    want = vtrace(*on["cpu"], 0.99)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # 256 steps of a recursion, fused multiply-adds on the card
    agree = all(torch.allclose(g, w, rtol=1e-4, atol=1e-4)
                for g, w in zip(got, want))
    ms = timing.time_ms(lambda: vtrace(*on["cuda"], 0.99), 20)
    t0 = time.perf_counter()
    for _ in range(20):
        vtrace(*on["cpu"], 0.99)
    cpu_ms = (time.perf_counter() - t0) / 20 * 1e3
    by_kernel, launches = timing.kernel_ms(
        lambda: vtrace(*on["cuda"], 0.99), 3)
    return {"rows": n, "ms": ms, "device_busy_ms": sum(by_kernel.values()),
            "launches": launches, "cpu_ms": cpu_ms,
            "max_abs_err_vs_cpu": err, "agree": agree,
            "rtol": 1e-4, "atol": 1e-4}


def phase_rllib_impala_group(smi):
    """``cartpole-impala-multilearner`` as the repo ships it: IMPALA, 2 env
    runners on CPUs, fragments of 256, seed 0, and 2 learner actors at
    ``num_gpus_per_learner=0.5`` on the one card, their gradients
    mean-allreduced as one flat vector over the "store" collective."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.rllib.run_regression import build_algorithm

    spec = _tuned_example(RLLIB["impala"])
    stop = spec["stop"]
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    init_s = time.perf_counter() - t0
    session_dir = global_worker.node.session_dir
    samples, updates = [], []
    try:
        t0 = time.perf_counter()
        algo = build_algorithm(spec)
        build_s = time.perf_counter() - t0
        group = algo.learner
        _timed_method(algo, "_sample_all", samples)
        _timed_method(group, "update", updates)
        iters, best, returns, iter_s = _train_to_bar(algo, stop)
        workers = group.workers
        infos = rt.get([w.device_info.remote() for w in workers], timeout=60)
        timings = rt.get([w.pop_timings.remote() for w in workers],
                         timeout=60)
        weights = rt.get([w.get_weights.remote() for w in workers],
                         timeout=60)
        learner_pids = {i["pid"] for i in infos}
        learner_fds = {pid: _card_fds(pid) for pid in learner_pids}
        on_card = _on_card(session_dir, learner_pids)
        timesteps = algo._timesteps
    finally:
        try:
            algo.stop()
        finally:
            rt.shutdown()
    left = _wait_for_no_processes(session_dir)
    w0, w1 = weights
    weight_diff = max(float(np.abs(w0[k] - w1[k]).max()) for k in w0)
    equal_bits = all(np.array_equal(w0[k], w1[k]) for k in w0)
    frags = spec["config"]["env_runners"]["num_env_runners"]
    rank_update_s = [[t["update_s"] for t in ts] for ts in timings]
    rank_allreduce_s = [[t["allreduce_s"] for t in ts] for ts in timings]
    vt = _vtrace_profile()
    train_s = sum(iter_s)
    emit("rllib_impala_group", config=f"{RLLIB['impala']} (ray_tpu_torch/"
         "rllib/tuned_examples): IMPALA, 2 CPU env runners, fragments of "
         "256, seed 0, 2 learner actors at num_gpus_per_learner=0.5, "
         "gradients mean-allreduced over the store collective",
         bar=stop["episode_return_mean"], budget=stop["training_iteration"],
         iterations=iters, best=best, returns=returns, timesteps=timesteps,
         sampled_rows=_rows(samples),
         env_steps_per_s=timesteps / train_s, train_s=train_s,
         init_s=init_s, build_s=build_s, iteration_s=iter_s,
         steady_env_steps_per_s=_steady_rate(samples, iter_s),
         sample_s=[s["s"] for s in samples],
         group_update_s=[u["s"] for u in updates],
         updates_per_iteration=frags,
         rank_update_s=rank_update_s, rank_allreduce_s=rank_allreduce_s,
         learners=infos, learner_card_fds=learner_fds,
         other_session_processes_on_card=on_card,
         rank_weights_max_abs_diff=weight_diff,
         rank_weights_equal_bits=equal_bits, vtrace=vt,
         processes_left=left, device_name=torch.cuda.get_device_name(0),
         nvidia_smi=smi,
         note="host clock around algo.train(), Algorithm._sample_all and "
              "LearnerGroup.update (one call a fragment); each rank's "
              "update and allreduce seconds on its own host clock (the "
              "update ends in a host read of its metrics); v-trace in the "
              "driver on the card and on the CPU")
    problems = []
    if best < stop["episode_return_mean"]:
        problems.append(f"best {best} below the bar in {iters} iterations")
    card = smi.split(",")[0].strip()
    if len(infos) != 2 or any(i["device"] == "cpu" or i["device_name"] != card
                              for i in infos):
        problems.append(f"learners {infos}")
    if not all(learner_fds.values()):
        problems.append(f"a learner has the card closed: {learner_fds}")
    if on_card:
        problems.append(f"other session processes on the card: {on_card}")
    if not all(np.allclose(w0[k], w1[k], rtol=RLLIB["rtol"],
                           atol=RLLIB["atol"]) for k in w0):
        problems.append(f"rank weights differ by {weight_diff}")
    if timesteps != _rows(samples):
        problems.append(f"timesteps {timesteps} vs sampled {_rows(samples)}")
    if not vt["agree"]:
        problems.append(f"v-trace on the card vs the CPU: {vt}")
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    if problems:
        raise AssertionError("rllib_impala_group: " + "; ".join(problems))


# phases 28-32: the second RLlib slice (offline RL, QMIX, R2D2, DreamerV3,
# DT), every learner in the driver on the card
RLLIB2 = {"marwil": "cartpole-marwil", "cql": "cartpole-cql",
          "dt": "cartpole-dt", "qmix": "twostep-qmix",
          "r2d2": "memorychain-r2d2",
          # BC as tests/test_rllib.py::test_bc_clones_expert runs it
          "bc": {"num_epochs": 20, "minibatch_size": 256, "lr": 3e-3},
          "bc_bar": 50.0,
          # tests/test_rllib_dreamerv3.py::test_dreamerv3_learns_cartpole
          "dreamer": {"seed": 0, "iterations": 35, "bar": 40.0},
          "batch_seed": 74}


def _learner_devices(params, optimizers):
    """(the devices of the parameters, of the optimizers' moment tensors)."""
    return (sorted({str(p.device) for p in params}),
            sorted({str(v.device) for opt in optimizers
                    for s in opt.state.values() for v in s.values()
                    if torch.is_tensor(v) and v.dim() > 0}))


def _flat(state, prefix=""):
    """{name: array} of a state, nested dicts' names joined with dots."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _cuda_vs_cpu(run, rtol, atol, apart=None):
    """``run(device) -> (metrics, weights)``: the learner's next update, from
    its trained weights and optimizer state (and target), on the same batch
    on the card and on the CPU, TF32 off. (A fresh Adam's first step, lr x
    g / (|g| + eps), turns the devices' rounding of a near-zero gradient
    into steps of up to lr.) Returns
    the max abs errors of the metrics and the weights, whether both agree
    at (rtol, atol) and whether to the bit. ``apart`` = (name suffix, atol)
    holds the weights whose names end so at their own limit."""
    (m_gpu, w_gpu), (m_cpu, w_cpu) = run("cuda"), run("cpu")
    w_gpu, w_cpu = _flat(w_gpu), _flat(w_cpu)
    main = [k for k in w_cpu if not (apart and k.endswith(apart[0]))]
    held = [k for k in w_cpu if k not in main]
    metric_err = max(abs(m_gpu[k] - m_cpu[k]) for k in m_cpu)
    err = lambda ks: max((float(np.abs(w_gpu[k] - w_cpu[k]).max())
                          for k in ks), default=0.0)
    close = all(np.allclose(m_gpu[k], m_cpu[k], rtol=rtol, atol=atol)
                for k in m_cpu) and all(
        np.allclose(w_gpu[k], w_cpu[k], rtol=rtol, atol=atol) for k in main)
    if held:
        close = close and err(held) <= apart[1]
    bits = m_gpu == m_cpu and all(np.array_equal(w_gpu[k], w_cpu[k])
                                  for k in w_cpu)
    out = {"metrics_max_abs_err": metric_err, "weights_max_abs_err":
           err(main), "rtol": rtol, "atol": atol, "agree": bool(close),
           "equal_bits": bool(bits)}
    if held:
        out.update(held_apart=held, held_apart_max_abs_err=err(held),
                   held_apart_atol=apart[1])
    return out


def _train_to_eval_bar(algo, bar, budget, evaluate):
    """``algo.train()`` then ``evaluate()`` (a greedy evaluation return) each
    iteration until the evaluation reaches the bar or the budget is spent:
    (iterations, best, evaluations, host seconds of each ``train()``, of
    each evaluation)."""
    evals, iter_s, eval_s = [], [], []
    for it in range(1, budget + 1):
        t0 = time.perf_counter()
        algo.train()
        iter_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        evals.append(evaluate())
        eval_s.append(time.perf_counter() - t0)
        if evals[-1] >= bar:
            break
    return it, max(evals), evals, iter_s, eval_s


def _rows_of(batch, n, seed):
    """``n`` rows of a SampleBatch drawn with numpy ``seed``."""
    from ray_tpu_torch.rllib.sample_batch import SampleBatch

    idx = np.random.default_rng(seed).integers(0, batch.count, n)
    return SampleBatch({k: np.asarray(v)[idx] for k, v in batch.items()})


def _driver_learner_fields(params, optimizers, session_dir, dev):
    """The learner's place: its parameters and moments on the card, the
    driver with the card open, no other session process with it open."""
    param_devices, state_devices = _learner_devices(params, optimizers)
    on_card = _on_card(session_dir, ()) if session_dir else {}
    fields = {"param_devices": param_devices,
              "adam_state_devices": state_devices,
              "session_processes_on_card": on_card,
              "driver_card_fds": _card_fds(os.getpid())}
    problems = []
    if param_devices != [str(dev)] or state_devices != [str(dev)]:
        problems.append(f"learner on {param_devices}, moments on "
                        f"{state_devices}")
    if on_card or not fields["driver_card_fds"]:
        problems.append(f"session processes on the card: {on_card}; the "
                        f"driver's open files on it: "
                        f"{fields['driver_card_fds']}")
    return fields, problems


def _offline_update(learner_cls, config, weights, opt_state, batch, dev):
    from ray_tpu_torch.rllib.rl_module import RLModule

    module = RLModule((4,), 2, seed=0, device=dev,
                      hiddens=config.model["hiddens"])
    module.set_state(weights)
    learner = learner_cls(module, config)
    # a copy: on the CPU, loading would share the moments it steps in place
    learner.set_optimizer_state(copy.deepcopy(opt_state))
    return learner.update(batch), module.get_state()


def phase_rllib_offline(smi):
    """``cartpole-marwil`` and ``cartpole-cql`` as the repo ships them, and BC
    as ``test_bc_clones_expert`` runs it, on the expert dataset
    ``run_regression.offline_dataset("cartpole_expert")`` makes once (PPO, 8
    iterations with its learner on the card, then 2 x 512 steps from its
    CPU runner). Each learner in the driver on the card, one CPU runner for
    the greedy evaluations. Returns {name: a function profiling one update
    of that learner}, to run after phase 25."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.rllib import BCConfig
    from ray_tpu_torch.rllib.offline import read_json_fragments
    from ray_tpu_torch.rllib.run_regression import (
        build_algorithm,
        offline_dataset,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    init_s = time.perf_counter() - t0
    session_dir = global_worker.node.session_dir
    rows, profiles, problems = {}, {}, []
    try:
        t0 = time.perf_counter()
        path = offline_dataset("cartpole_expert")
        dataset_s = time.perf_counter() - t0
        frags = read_json_fragments(path)
        runs = [(key, _tuned_example(RLLIB2[key])) for key in ("marwil",
                                                               "cql")]
        runs.append(("bc", {"stop": {"evaluation_return_mean":
                                     RLLIB2["bc_bar"],
                                     "training_iteration": 1}}))
        for key, spec in runs:
            stop = spec["stop"]
            t0 = time.perf_counter()
            if key == "bc":
                algo = BCConfig().environment("CartPole-native").offline_data(
                    input_=path).training(**RLLIB2["bc"]).build()
            else:
                algo = build_algorithm(spec)
            build_s = time.perf_counter() - t0
            try:
                _zero_launches()
                iters, best, evals, iter_s, eval_s = _train_to_eval_bar(
                    algo, stop["evaluation_return_mean"],
                    stop["training_iteration"],
                    lambda: algo.evaluate()["evaluation"][
                        "episode_return_mean"])
                flash = _read_launches()
                learner, cfg = algo.learner, algo.config
                place, bad = _driver_learner_fields(
                    learner.params, [learner.optimizer], session_dir, dev)
                batch = (_rows_of(algo._dataset, cfg.minibatch_size,
                                  RLLIB2["batch_seed"]) if key == "cql"
                         else algo._dataset)
                weights = learner.get_weights()
                opt_state = learner.get_optimizer_state()
                cuda_cpu = _cuda_vs_cpu(
                    lambda d, lc=type(learner), c=cfg, w=weights,
                    o=opt_state, b=batch: _offline_update(lc, c, w, o, b, d),
                    RLLIB["rtol"], RLLIB["atol"])
                timesteps = algo._timesteps
            finally:
                algo.stop()
            train_s = sum(iter_s)
            row = {"config": "BCConfig as test_bc_clones_expert runs it: "
                             "20 epochs x minibatch 256, lr 3e-3"
                   if key == "bc" else RLLIB2[key],
                   "bar": stop["evaluation_return_mean"],
                   "budget": stop["training_iteration"], "iterations": iters,
                   "best_evaluation": best, "evaluations": evals,
                   "timesteps": timesteps, "samples_per_s": timesteps / train_s,
                   "train_s": train_s, "iteration_s": iter_s,
                   "evaluate_s": eval_s, "build_s": build_s,
                   "flash_launches": flash, "cuda_vs_cpu_update": cuda_cpu,
                   "update_batch_rows": batch.count, **place}
            rows[key] = row
            profiles[f"{key}_update"] = (
                lambda l=learner, b=batch: _update_profile(l, b))
            if best < stop["evaluation_return_mean"]:
                bad.append(f"best evaluation {best} below the bar in "
                           f"{iters} iterations")
            if not cuda_cpu["agree"]:
                bad.append(f"CUDA vs CPU update: {cuda_cpu}")
            if any(flash.values()):
                bad.append(f"flash kernels launched: {flash}")
            problems += [f"{key}: {p}" for p in bad]
    finally:
        rt.shutdown()
    left = _wait_for_no_processes(session_dir)
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    emit("rllib_offline", dataset=path, dataset_s=dataset_s,
         dataset_rows=sum(f.count for f in frags),
         dataset_fragments=len(frags), init_s=init_s, runs=rows,
         processes_left=left, device_name=torch.cuda.get_device_name(dev),
         nvidia_smi=smi,
         note="each train() then a greedy evaluate() on the CPU runner "
              "until the evaluation return reaches the bar; host clock; "
              "samples/s = dataset rows consumed by the learner a second; "
              "the update profiles (one learner.update: the whole "
              "dataset's epochs for MARWIL and BC, one minibatch of 256 for "
              "CQL) are in the rllib_update_profiles line")
    if problems:
        raise AssertionError("rllib_offline: " + "; ".join(problems))
    return profiles


def _replay_phase(smi, key, make_batch, make_learner, rows_per_iteration):
    """A tuned example with CPU runners and a replay buffer (QMIX, R2D2),
    the learner in the driver on the card: ``train()`` to the yaml's
    ``episode_return_mean`` bar, then the learner's next update (its
    weights, Adam state and target) on one buffer sample on the card and on
    the CPU. Returns
    (the phase's fields, its problems, a function profiling one update)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.rllib.run_regression import build_algorithm

    spec = _tuned_example(RLLIB2[key])
    stop = spec["stop"]
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    init_s = time.perf_counter() - t0
    session_dir = global_worker.node.session_dir
    updates = []
    try:
        t0 = time.perf_counter()
        algo = build_algorithm(spec)
        build_s = time.perf_counter() - t0
        learner = algo.learner
        _timed_method(learner, "update", updates)
        _zero_launches()
        iters, best, returns, iter_s = _train_to_bar(algo, stop)
        flash = _read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        place, problems = _driver_learner_fields(
            learner.params, [learner.optimizer], session_dir, dev)
        timesteps, cfg = algo._timesteps, algo.config
        batch = make_batch(algo)
        weights = learner.get_weights()
        opt_state = learner.get_optimizer_state()  # with the target

        def run(d):
            fresh = make_learner(cfg, d)
            fresh.module.set_state(weights)
            fresh.set_optimizer_state(copy.deepcopy(opt_state))
            return fresh.update(batch), fresh.get_weights()

        cuda_cpu = _cuda_vs_cpu(run, RLLIB["rtol"], RLLIB["atol"])
    finally:
        try:
            algo.stop()
        finally:
            rt.shutdown()
    left = _wait_for_no_processes(session_dir)
    train_s = sum(iter_s)
    row = {"config": f"{RLLIB2[key]} (ray_tpu_torch/rllib/tuned_examples)",
           "bar": stop["episode_return_mean"],
           "budget": stop["training_iteration"], "iterations": iters,
           "best": best, "returns": returns, "timesteps": timesteps,
           "env_steps_per_s": timesteps / train_s, "train_s": train_s,
           "iteration_s": iter_s, "init_s": init_s, "build_s": build_s,
           "update_s": [u["s"] for u in updates],
           "learner_peak_memory_bytes": peak, "flash_launches": flash,
           "cuda_vs_cpu_update": cuda_cpu, "processes_left": left,
           "update_batch_rows": len(batch["rewards"]), **place,
           "device_name": torch.cuda.get_device_name(dev),
           "nvidia_smi": smi}
    if best < stop["episode_return_mean"]:
        problems.append(f"best {best} below the bar in {iters} iterations")
    if timesteps != rows_per_iteration(cfg) * iters:
        problems.append(f"timesteps {timesteps} vs "
                        f"{rows_per_iteration(cfg)} x {iters} iterations")
    if not cuda_cpu["agree"]:
        problems.append(f"CUDA vs CPU update: {cuda_cpu}")
    if any(flash.values()):
        problems.append(f"flash kernels launched: {flash}")
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    return row, problems, lambda: _update_profile(learner, batch)


def phase_rllib_qmix(smi):
    """``twostep-qmix`` as the repo ships it: QMIX, one CPU runner,
    fragments of 64, lr 5e-3, 8 updates of minibatch 64 an iteration,
    seed 3."""
    from ray_tpu_torch.rllib.qmix import QMixLearner, QMixModule

    def make_learner(cfg, d):
        module = QMixModule(3, 2, 2, 3, hiddens=tuple(cfg.model["hiddens"]),
                            embed_dim=cfg.mixing_embed_dim, device=d)
        return QMixLearner(module, cfg)

    row, problems, profile = _replay_phase(
        smi, "qmix", lambda algo: algo.buffer.sample(
            algo.config.minibatch_size), make_learner,
        lambda cfg: cfg.rollout_fragment_length * cfg.num_env_runners)
    emit("rllib_qmix", **row, note="host clock around algo.train() and "
         "learner.update (which ends in a host read of its metrics); the "
         "bar is the runner's training return (epsilon-greedy)")
    if problems:
        raise AssertionError("rllib_qmix: " + "; ".join(problems))
    return profile


def phase_rllib_r2d2(smi):
    """``memorychain-r2d2`` as the repo ships it: R2D2, one CPU runner, 32
    episodes of length 4 an iteration, lr 2e-3, 8 updates of 32 sequences,
    seed 0."""
    from ray_tpu_torch.rllib.r2d2 import R2D2Learner, R2D2Module

    def make_learner(cfg, d):
        return R2D2Learner(R2D2Module(3, 2, hidden=cfg.model["hidden"],
                                      device=d), cfg)

    row, problems, profile = _replay_phase(
        smi, "r2d2", lambda algo: algo.buffer.sample(
            algo.config.minibatch_size), make_learner,
        # MemoryChain's episodes run their full length, the sequence's
        lambda cfg: cfg.episodes_per_iteration * cfg.env_config["length"])
    emit("rllib_r2d2", **row, note="host clock around algo.train() and "
         "learner.update (which ends in a host read of its metrics); the "
         "bar is the runner's training return (epsilon-greedy); one update "
         "unrolls the online and target LSTMs over 5 steps")
    if problems:
        raise AssertionError("rllib_r2d2: " + "; ".join(problems))
    return profile


def phase_rllib_dreamerv3(smi):
    """DreamerV3 as ``tests/test_rllib_dreamerv3.py::
    test_dreamerv3_learns_cartpole`` runs it: ``DreamerV3Config()`` on
    CartPole, seed 0, 35 iterations of 200 env steps (one collector env in
    the driver, the policy on the card) and 8 updates of batch 8 x 32 with
    horizon 15; the best training return above 40; the state round trip
    and a 2-episode greedy evaluation."""
    from ray_tpu_torch.rllib import DreamerV3Config
    from ray_tpu_torch.rllib.learner import _opt_state
    from ray_tpu_torch.rllib.rl_module import set_state

    spec = RLLIB2["dreamer"]
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = DreamerV3Config().environment("CartPole-native").debugging(
        seed=spec["seed"])
    t0 = time.perf_counter()
    algo = cfg.build()
    build_s = time.perf_counter() - t0
    updates, collects = [], []
    _timed_method(algo, "train_step", updates)
    _timed_method(algo, "_collect", collects)
    _zero_launches()
    returns, iter_s = [], []
    for _ in range(spec["iterations"]):
        t0 = time.perf_counter()
        returns.append(algo.train().get("episode_return_mean"))
        iter_s.append(time.perf_counter() - t0)
    flash = _read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    best = max(r for r in returns if r is not None)
    m = algo.module
    params = [p for net in (m.wm, m.actor, m.critic) for p in net.parameters()]
    place, problems = _driver_learner_fields(
        params, [algo.wm_opt, algo.actor_opt, algo.critic_opt], None, dev)
    state = m.get_state()
    m.set_state(state)
    again = _flat(m.get_state())
    round_trip = all(np.array_equal(again[k], v)
                     for k, v in _flat(state).items())
    ev = algo.evaluate(episodes=2)["evaluation"]
    batch = algo._sample_batch()
    ema = {k: v.detach().cpu().numpy().copy()
           for k, v in algo.critic_ema.state_dict().items()}
    opts = ("wm_opt", "actor_opt", "critic_opt")
    opt_states = {name: _opt_state(getattr(algo, name)) for name in opts}
    ret_range = float(algo._ret_range)
    drawn = {}

    def run(d):
        fresh = cfg.copy().learners(
            num_gpus_per_learner=1 if d == "cuda" else 0).build()
        try:
            fresh.module.set_state(state)
            set_state(fresh.critic_ema, ema)
            for name in opts:
                getattr(fresh, name).load_state_dict(
                    copy.deepcopy(opt_states[name]))
            fresh._ret_range.fill_(ret_range)
            samples = drawn.get("samples")
            if samples is not None:
                samples = type(samples)(*(s.to(d) for s in samples))
            metrics, used = fresh.train_step(batch, samples)
            drawn.setdefault("samples", used)
            return ({k: float(v) for k, v in metrics.items()},
                    fresh.module.get_state())
        finally:
            fresh.stop()

    cuda_cpu = _cuda_vs_cpu(run, RLLIB["rtol"], RLLIB["atol"])
    timesteps = algo._timesteps
    algo.stop()
    train_s = sum(iter_s)
    row = {"config": "DreamerV3Config() on CartPole-native, seed 0 (the "
                     "reference test's contract)",
           "bar": spec["bar"], "iterations": spec["iterations"],
           "best": best, "returns": returns, "timesteps": timesteps,
           "env_steps_per_s": timesteps / train_s, "train_s": train_s,
           "iteration_s": iter_s, "build_s": build_s,
           "collect_s": [c["s"] for c in collects],
           "update_s": [u["s"] for u in updates],
           "state_round_trip_equal_bits": round_trip, "evaluation": ev,
           "learner_peak_memory_bytes": peak, "flash_launches": flash,
           "cuda_vs_cpu_update": cuda_cpu, **place,
           "device_name": torch.cuda.get_device_name(dev),
           "nvidia_smi": smi}
    emit("rllib_dreamerv3", **row, note="host clock around train(), "
         "DreamerV3._collect (200 steps, one policy step on the card each) "
         "and DreamerV3.train_step (which does not wait for the card; the "
         "iteration's host read of its metrics does); the CPU update "
         "replays the card's latent and action draws")
    if not best > spec["bar"]:
        problems.append(f"best {best} not above {spec['bar']} in "
                        f"{spec['iterations']} iterations")
    if not round_trip or ev["num_episodes"] != 2:
        problems.append(f"state round trip {round_trip}, evaluation {ev}")
    if not cuda_cpu["agree"]:
        problems.append(f"CUDA vs CPU update: {cuda_cpu}")
    if any(flash.values()):
        problems.append(f"flash kernels launched: {flash}")
    if problems:
        raise AssertionError("rllib_dreamerv3: " + "; ".join(problems))
    learner = types.SimpleNamespace(update=lambda b: algo.train_step(b))
    return lambda: _update_profile(learner, batch)


@contextlib.contextmanager
def _capture_dt_attention():
    """Record what the Decision Transformer hands ``flash_attention``: a
    list that fills, one dict a call, with q, k, v folded to (B*H, S, D)
    (copies) and, once the backward has run, the call's dO."""
    from ray_tpu_torch.rllib import dt

    kernel_path = dt.flash_attention
    seen = []
    fold = lambda t: t.detach().reshape(-1, *t.shape[-2:]).clone(
        memory_format=torch.contiguous_format)

    def recording(q, k, v, **kw):
        out = kernel_path(q, k, v, **kw)
        rec = {"q": fold(q), "k": fold(k), "v": fold(v), "kw": kw}
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("do", fold(g)))
        seen.append(rec)
        return out

    dt.flash_attention = recording
    try:
        yield seen
    finally:
        dt.flash_attention = kernel_path


def _dt_activation_rows(calls, label):
    """Each captured DT call through the three kernels against their plain
    versions on its real activations, element by element at the f32
    ``TOLS``: the forward always, the backward where a dO was captured."""
    rows = []
    for i, rec in enumerate(calls):
        q, k, v = rec["q"], rec["k"], rec["v"]
        ok, out_err, lse_err, share = _check_flash(q, k, v, True)
        row = {"call": f"{label} layer {i}", "bh": q.shape[0],
               "s": q.shape[1], "d": q.shape[2], "dtype": "float32",
               "ok": ok, "flash_fwd_err": out_err, "lse_err": lse_err,
               "flash_fwd_share_of_limit": share}
        if "do" in rec:
            b_ok, errs, shares, _ = _check_bwd(q, k, v, rec["do"], True)
            row.update(ok=ok and b_ok, flash_bwd_dq_err=errs[0],
                       flash_bwd_dkv_err=max(errs[1:]),
                       flash_bwd_dq_share_of_limit=shares[0],
                       flash_bwd_dkv_share_of_limit=max(shares[1:]))
        rows.append(row)
    return rows


def _dt_kernel_rows(shapes, launches, act_rows):
    """The DT path's rows of the ``kernels`` line: the three kernels at the
    training shape ``shapes["train"]`` (B, H, S, D: minibatch, heads, 3 x
    context, 32; causal, f32) and ``flash_fwd`` at the acting shape
    ``shapes["act"]`` (B 1), on inputs from
    a seed: ms by CUDA events, the plain versions' ms, SDPA's f32 forward
    (and backward) as a yardstick, the bound against the f32 CUDA-core
    peak; errors from the real activations (``act_rows``). Returns
    (entries, a function giving their profiler fields, to run after every
    CUDA-event timing)."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools import timing

    entries, profiles = [], []
    for path, (b, h, s, d), names in (
            ("dt_train", shapes["train"], KERNELS),
            ("dt_act", shapes["act"], ("flash_fwd",))):
        bh = b * h
        err = {name: max(r.get(f"{name}_err", 0.0) for r in act_rows[path])
               for name in names}
        gen = torch.Generator(device="cuda").manual_seed(RLLIB2["batch_seed"])
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda")
                       for _ in range(4))
        kw = dict(causal=True, sm_scale=d ** -0.5)
        out, lse = attn.flash_attention_fwd(q, k, v, causal=True)
        delta = attn._delta(out, do)
        calls = {"flash_fwd": lambda: attn.flash_attention_fwd(
                     q, k, v, causal=True),
                 "flash_bwd_dq": lambda: attn._flash_bwd_dq_kernel(
                     q, k, v, do, lse, delta, **kw),
                 "flash_bwd_dkv": lambda: attn._flash_bwd_dkv_kernel(
                     q, k, v, do, lse, delta, **kw)}
        plain = {"flash_fwd": lambda: attn._flash_plain(q, k, v, **kw),
                 "flash_bwd_dq": lambda: attn._bwd_dq_plain(
                     q, k, v, do, lse, delta, block_q=64, block_k=64, **kw),
                 "flash_bwd_dkv": lambda: attn._bwd_dkv_plain(
                     q, k, v, do, lse, delta, block_q=64, block_k=64, **kw)}
        q4, k4, v4 = (t.view(b, h, s, d).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)
        sdpa_fwd_bwd = lambda: torch.autograd.grad(
            sdpa(), (q4, k4, v4), do.view(b, h, s, d))
        sdpa_fwd_ms = timing.time_ms(sdpa, 50)
        library = {"flash_fwd": (sdpa_fwd_ms, "torch SDPA forward, f32")}
        if len(names) == 3:
            bwd_ms = timing.time_ms(sdpa_fwd_bwd, 50) - sdpa_fwd_ms
            for name in KERNELS[1:]:
                library[name] = (bwd_ms, "torch SDPA backward, f32 (dq, dk "
                                 "and dv together)")
        live = _live_pairs(bh, s, s, True)
        n, stats = bh * s * d, bh * s * 4
        flops = {"flash_fwd": 4 * live * d, "flash_bwd_dq": 6 * live * d,
                 "flash_bwd_dkv": 8 * live * d}
        nbytes = {"flash_fwd": 4 * n * 4 + stats,
                  "flash_bwd_dq": 5 * n * 4 + 2 * stats,
                  "flash_bwd_dkv": 6 * n * 4 + 2 * stats}
        group = []
        for name in names:
            ms = timing.time_ms(calls[name], 100)
            plain_ms = timing.time_ms(plain[name], 10)
            entry = _entry(
                name, launches[path][name], err[name], ms, plain_ms,
                _bound(nbytes[name], flops[name], F32_FLOPS_PER_S),
                library[name][0], flops[name],
                (attn.fwd_design if name == "flash_fwd" else
                 attn.bwd_design)(torch.float32), path=path,
                bound_peak="67 TFLOP/s f32 (CUDA cores) and 3.35 TB/s",
                tolerance=_tol_fields(torch.float32),
                err_from="DT's real activations in this run (phase 32)",
                library=library[name][1],
                shape={"bh": bh, "s": s, "d": d, "causal": True,
                       "dtype": "float32"})
            group.append(entry)
        entries += group

        def profile(group=group, calls=calls):
            for e in group:
                e.update(_launch_profile(calls[e["name"]]))
        profiles.append(profile)
    return entries, lambda: [p() for p in profiles]


def phase_rllib_dt(smi):
    """``cartpole-dt`` as the repo ships it: DT on the expert dataset (phase
    28's file), context 8, minibatch 128 x 25 updates an iteration, lr
    1e-3, seed 0, the learner in the driver on the card; attention through
    the three f32 flash kernels at D 32, S 24. Returns (the DT path's kernel
    rows, a function adding their profiler fields, a function profiling
    one update)."""
    from ray_tpu_torch.rllib.dt import DTLearner, DTModule
    from ray_tpu_torch.rllib.run_regression import build_algorithm

    spec = _tuned_example(RLLIB2["dt"])
    stop = spec["stop"]
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    algo = build_algorithm(spec)
    build_s = time.perf_counter() - t0
    cfg, m = algo.config, algo.module
    launches = {"dt_train": dict.fromkeys(KERNELS, 0),
                "dt_act": dict.fromkeys(KERNELS, 0)}

    def counted(path, fn):
        _zero_launches()
        out = fn()
        for name, n in _read_launches().items():
            launches[path][name] += n
        return out

    evaluate = lambda: counted("dt_act", algo.evaluate)["evaluation"][
        "episode_return_mean"]
    train, algo.train = algo.train, lambda: counted("dt_train", train)
    iters, best, evals, iter_s, eval_s = _train_to_eval_bar(
        algo, stop["evaluation_return_mean"], stop["training_iteration"],
        evaluate)
    algo.train = train
    peak = torch.cuda.max_memory_allocated(dev)
    place, problems = _driver_learner_fields(
        algo.learner.params, [algo.learner.optimizer], None, dev)
    # launches around one update and one action, and the activations
    mb = algo._sample_windows(cfg.minibatch_size)
    with _capture_dt_attention() as seen:
        _zero_launches()
        algo.learner.update(mb)
        per_update = _read_launches()
        train_calls = list(seen)
        seen.clear()
        algo.start_episode(target_return=100.0)
        obs = np.random.default_rng(RLLIB2["batch_seed"]).normal(
            size=(cfg.context_len + 2, m.obs_dim)).astype(np.float32)
        for o in obs[:-1]:
            algo.compute_single_action(o)
            algo.observe_reward(1.0)
        seen.clear()
        _zero_launches()
        algo.compute_single_action(obs[-1])
        per_action = _read_launches()
        act_calls = list(seen)
    act_rows = {"dt_train": _dt_activation_rows(train_calls, "update"),
                "dt_act": _dt_activation_rows(act_calls, "action")}
    weights = algo.learner.get_weights()
    opt_state = algo.learner.get_optimizer_state()
    d = cfg.model["d_model"]

    def run(dv):
        module = DTModule(m.obs_dim, m.num_actions, cfg.context_len,
                          d_model=d, n_layer=cfg.model["n_layer"],
                          n_head=cfg.model["n_head"],
                          max_timestep=cfg.max_timestep, device=dv)
        module.set_state(weights)
        learner = DTLearner(module, cfg)
        learner.set_optimizer_state(copy.deepcopy(opt_state))
        metrics = learner.update(mb)
        state = module.get_state()
        # the key bias: softmax does not see it, its gradient is rounding
        # noise, whose moments Adam divides: steps of up to lr that differ
        # between the devices
        for i in range(cfg.model["n_layer"]):
            b = state.pop(f"attn_qkv_{i}.bias")
            state[f"attn_qkv_{i}.bias[q,v]"] = np.concatenate(
                [b[:d], b[2 * d:]])
            state[f"attn_qkv_{i}.bias[k]"] = b[d:2 * d]
        return metrics, state

    # kernel path (card) against plain path (CPU): the f32 kernels' TOLS
    f32_atol, f32_rtol = TOLS[torch.float32]
    cuda_cpu = _cuda_vs_cpu(run, f32_rtol, f32_atol,
                            apart=(".bias[k]", 2 * cfg.lr * (1 + 1e-4)))
    timesteps = algo._timesteps
    algo.stop()
    h = cfg.model["n_head"]
    shapes = {"train": (cfg.minibatch_size, h, 3 * cfg.context_len, d // h),
              "act": (1, h, 3 * cfg.context_len, d // h)}
    train_s = sum(iter_s)
    row = {"config": f"{RLLIB2['dt']} (ray_tpu_torch/rllib/tuned_examples)",
           "bar": stop["evaluation_return_mean"],
           "budget": stop["training_iteration"], "iterations": iters,
           "best_evaluation": best, "evaluations": evals,
           "timesteps": timesteps, "samples_per_s": timesteps / train_s,
           "train_s": train_s, "iteration_s": iter_s, "evaluate_s": eval_s,
           "build_s": build_s, "launches": launches,
           "launches_per_update": per_update,
           "launches_per_action": per_action,
           "real_activations": act_rows, "cuda_vs_cpu_update": cuda_cpu,
           "cuda_vs_cpu_limit": "the f32 kernels' TOLS: the card runs the "
                                "flash kernels, the CPU their plain versions",
           "learner_peak_memory_bytes": peak, **place,
           "device_name": torch.cuda.get_device_name(dev),
           "nvidia_smi": smi}
    emit("rllib_dt", **row, note="each train() (25 updates) then a greedy "
         "return-conditioned evaluate() in the driver until the "
         "evaluation return reaches the bar; launches read around "
         "training and evaluation apart")
    if best < stop["evaluation_return_mean"]:
        problems.append(f"best evaluation {best} below the bar in {iters} "
                        "iterations")
    n_layer = cfg.model["n_layer"]
    if per_update != dict.fromkeys(KERNELS, n_layer):
        problems.append(f"launches per update {per_update}")
    if per_action != {"flash_fwd": n_layer, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}:
        problems.append(f"launches per action {per_action}")
    bad = [r["call"] for rs in act_rows.values() for r in rs if not r["ok"]]
    if bad or len(act_rows["dt_train"]) != n_layer or any(
            "do" not in c for c in train_calls):
        problems.append(f"kernels vs plain on DT's activations: {bad}")
    if not cuda_cpu["agree"]:
        problems.append(f"CUDA vs CPU update: {cuda_cpu}")
    if problems:
        raise AssertionError("rllib_dt: " + "; ".join(problems))
    entries, kernel_profile = _dt_kernel_rows(shapes, launches, act_rows)
    learner = algo.learner
    return entries, kernel_profile, lambda: _update_profile(learner, mb)


# phase 33: the port run as a cluster, through the commands a user types
# (``tools/cluster_runs.py``): a head of 4 CPUs and no GPU, one worker node
# type ``gpu_node`` ({"GPU": 1, "CPU": 4}, 0 to 1 of it, 6 s idle), and a
# submitted job whose TorchTrainer gang trains phase 8's configuration,
# weights and batch for 4 steps over a hybrid mesh on the launched node
CLUSTER_JOB = {"model": "gpt2_124m", "device": "cuda", "use_gpu": True,
               "workers": 1, "steps": 4}


def cluster_cli_drive():
    """Phase 33's run: ``python -m ray_tpu_torch up/status/submit/job logs/
    microbenchmark/down`` as subprocesses under a temporary ``HOME``
    (``tools/cluster_runs.drive``). No cluster of this process takes part,
    so it runs on a thread beside phases 28-31; ``phase_cluster_cli`` holds
    what it returns to its checks once phase 8 has run."""
    import shutil
    import tempfile

    from ray_tpu_torch.tools import cluster_runs, train_runs

    workdir = tempfile.mkdtemp(prefix="cluster_cli_")
    config = dict(CLUSTER_JOB, batch=train_runs.BATCH, seq=train_runs.SEQ)
    try:
        return cluster_runs.drive(workdir, config, {"GPU": 1, "CPU": 4},
                                  name="chip-smoke", job_timeout_s=600)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def phase_cluster_cli(smi, out, bf16_losses, inproc_step_ms):
    """Phase 33's checks on ``cluster_cli_drive``'s ``out``: the autoscaler
    launched ``gpu_node`` for the submitted job's gang, the gang trained
    there through the three kernels, the idle node was torn down and
    ``down`` left no process of the session. Returns the worker's launch
    counts."""
    from ray_tpu_torch.tools import cluster_runs, train_runs

    steps = CLUSTER_JOB["steps"]
    problems = cluster_runs.problems(out, steps, GPT2_124M["n_layer"])
    reps = (out.get("job") or {}).get("steps") or []
    losses = [r["loss"] for r in reps]
    step_ms = [r["step_ms"] for r in reps]
    rows = [ln for ln in out.get("microbenchmark", "").splitlines()
            if ln.strip()]
    card = smi.split(",")[0].strip()
    diff = max((abs(a - b) for a, b in zip(losses, bf16_losses)),
               default=None)
    emit("cluster_cli",
         config="gpt2_124m attention=flash loss_chunks=8 bf16/f32-params "
                "AdamW, TorchTrainer(ScalingConfig(num_workers=1, "
                "use_gpu=True)) over create_hybrid_mesh({'fsdp': 1}, "
                "{'data': 1}), shard_train_state(fsdp=True)",
         batch=train_runs.BATCH, seq=train_runs.SEQ, up_s=out.get("up_s"),
         submit_to_node_s=out.get("submit_to_node_s"),
         gang_start_s=out.get("gang_start_s"),
         worker_step_ms=statistics.median(step_ms[1:]) if step_ms else None,
         worker_step_ms_each=step_ms, inproc_step_ms=inproc_step_ms,
         job_wall_s=out.get("job_wall_s"), teardown_s=out.get("teardown_s"),
         down_s=out.get("down_s"), losses=losses,
         phase8_losses=bf16_losses[:steps], max_loss_diff_vs_phase8=diff,
         equal_to_the_bit=losses == bf16_losses[:steps],
         launches=reps[-1]["launches"] if reps else None,
         worker_node=reps[0]["node_id"] if reps else None,
         head_nodes=[n["node_id"] for n in out.get("nodes_before") or []],
         mesh=reps[0]["mesh"] if reps else None,
         worker_device_name=reps[0]["device_name"] if reps else None,
         status=out.get("status"), microbenchmark=rows,
         microbenchmark_s=out.get("microbenchmark_s"),
         processes_left=out.get("processes_left"),
         note="seconds on the host clock: up_s the `up` command; "
              "submit_to_node_s from starting `submit` to the launched "
              "node in the GCS's node table; gang_start_s from fit() to "
              "the worker's loop; job_wall_s submit to its end; "
              "teardown_s the job's end to the idle node's removal; step "
              "ms around one step and its float(loss) in the worker")
    if reps and any(r["device_name"] != card for r in reps):
        problems.append(f"worker device {reps[0]['device_name']} is not "
                        f"nvidia-smi's {card!r}")
    if not (losses and all(math.isfinite(x) for x in losses)
            and diff is not None and diff <= 1e-2):
        problems.append(f"losses {losses} vs phase 8's "
                        f"{bf16_losses[:steps]}")
    if out.get("microbenchmark_rc") != 0 or not rows:
        problems.append(f"microbenchmark rc {out.get('microbenchmark_rc')}")
    if problems:
        raise AssertionError("cluster_cli: " + "; ".join(problems))
    return reps[-1]["launches"]


# phase 34: phase 19's GPT-2 deployment under load_harness with replica
# autoscaling: 1 to 2 replicas at half a card each, a target of 2 ongoing
# requests a replica, 8 connections, phase 6's prompts in turn at 8
# requests a second for 10 s (more than one replica answers: 5.6 a second
# on an H100 at 12 offered), then windows of 5 s until the second replica
# has served (at most 7: 45 s of load in all)
SERVE_AUTOSCALE = {"target_ongoing": 2, "connections": 8, "rps": 8.0,
                   "load_s": 10.0, "window_s": 5.0, "max_windows": 7}


def _replica_actors(app, deployment):
    """{replica name: actor} of a deployment, from its controller."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve._common import (SERVE_CONTROLLER_NAME,
                                             SERVE_NAMESPACE)

    controller = rt.get_actor(SERVE_CONTROLLER_NAME,
                              namespace=SERVE_NAMESPACE)
    names = rt.get(controller.get_replica_names.remote(app, deployment),
                   timeout=60)
    return {n: rt.get_actor(n, namespace=SERVE_NAMESPACE) for n in names}


def _probe_replicas(app, deployment, reset=False):
    """Each replica's ``probe`` (its own launch counts, forwards, pid and
    device), asked of its actor directly: counters are per process."""
    import ray_tpu_torch as rt

    return {name: rt.get(actor.handle_request.remote(
        "probe", (), {"reset": reset}), timeout=60)
        for name, actor in _replica_actors(app, deployment).items()}


def serve_autoscale(model_kwargs, bind_kwargs, prompts, want, num_gpus,
                    init_kwargs, load=SERVE_AUTOSCALE):
    """Deploys ``_probed_llm_server()`` with replica autoscaling (1 to 2,
    ``ray_actor_options={"num_gpus": num_gpus}``), drives it with
    ``load_harness.run_load`` over ``prompts`` in turn and holds every
    answer to ``want`` (the in-process greedy tokens of each prompt).
    Returns what it saw; the caller checks the rest."""
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.serve.load_harness import run_load

    rt.init(**init_kwargs)
    session_dir = global_worker.node.session_dir
    out = {"windows": [], "answers_wrong": [], "scale_up_s": None}
    try:
        app = serve.deployment(_probed_llm_server(), name="llm").options(
            ray_actor_options={"num_gpus": num_gpus},
            autoscaling_config={
                "min_replicas": 1, "max_replicas": 2,
                "target_ongoing_requests": load["target_ongoing"],
                "upscale_delay_s": 0.5, "downscale_delay_s": 600.0},
        ).bind(real_model=True, model_kwargs=model_kwargs, **bind_kwargs)
        t0 = time.perf_counter()
        serve.run(app, name="auto", route_prefix="/llm")
        out["replica_start_s"] = time.perf_counter() - t0
        port = serve.http_port()
        url = f"http://127.0.0.1:{port}/llm"
        # a first request: the fresh replica's first forward
        _http_stream(port, prompts[0], 2)
        _probe_replicas("auto", "llm", reset=True)
        status = lambda: serve.status()["auto"]["deployments"]["llm"]
        out["replicas_before"] = status()["running_replicas"]
        stop, t_load = threading.Event(), time.perf_counter()

        def watch():
            while not stop.is_set():
                if status()["running_replicas"] >= 2 and \
                        out["scale_up_s"] is None:
                    out["scale_up_s"] = time.perf_counter() - t_load
                time.sleep(0.25)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        payloads = [json.dumps({"tokens": p, "max_tokens": len(want[0])})
                    .encode() for p in prompts]
        duration = load["load_s"]
        for _ in range(1 + load["max_windows"]):
            res = run_load(url, rps=load["rps"], duration_s=duration,
                           connections=load["connections"], method="POST",
                           payloads=payloads, keep_bodies=True,
                           timeout_s=120)
            for b in res.pop("bodies"):
                toks = [json.loads(line)["token"]
                        for line in b["body"].decode().splitlines()
                        if line.strip()]
                if b["status"] != 200 or toks != want[b["i"] % len(want)]:
                    out["answers_wrong"].append(
                        {"i": b["i"], "status": b["status"], "tokens": toks})
            res.pop("queue_depth_series", None)
            out["windows"].append(res)
            probes = _probe_replicas("auto", "llm")
            if len(probes) >= 2 and all(p["forwards"] for p in
                                        probes.values()):
                break
            duration = load["window_s"]
        stop.set()
        watcher.join()
        out["load_s"] = time.perf_counter() - t_load
        out["replicas"] = probes
        out["status"] = status()
    finally:
        serve.shutdown()
        rt.shutdown()
    out["processes_left"] = _wait_for_no_processes(session_dir)
    return out


def _merge_windows(windows):
    """The requests, answers, errors and seconds of every window together
    (each window's percentiles stay its own)."""
    n = sum(w["requests"] for w in windows)
    ok = sum(w["ok"] for w in windows)
    return {"requests": n, "ok": ok,
            "errors": sum(w["errors"] for w in windows),
            "wall_s": sum(w["wall_s"] for w in windows)}


def phase_serve_autoscale(smi, bf16_streams):
    """GPT-2-124M's ``LLMServer`` deployment (phase 19's app) with replica
    autoscaling, driven by ``load_harness.run_load``: it scales from 1 to
    2 replicas, both launch ``flash_fwd`` and every answer equals phase
    6's in-process greedy tokens for its prompt. Returns the replicas'
    summed launch counts."""
    prompts = phase6_prompts()
    want = [list(s) for s in bf16_streams[:4]]
    os.environ["RAY_TPU_TORCH_gpu_autodetect"] = "1"  # the raylet's probe
    try:
        out = serve_autoscale(
            dict(attention="flash", dtype=torch.bfloat16, **GPT2_124M),
            dict(kv_dim=768, page_tokens=16, max_pages=512, max_running=8,
                 prefix_cache_pages=128),
            prompts, want, 0.5, dict(num_cpus=4, num_gpus=1))
    finally:
        os.environ.pop("RAY_TPU_TORCH_gpu_autodetect", None)
    reps = out.get("replicas") or {}
    launches = {k: sum(p["launches"][k] for p in reps.values())
                for k in KERNELS}
    total = _merge_windows(out["windows"])
    tokens = total["ok"] * len(want[0])
    card = smi.split(",")[0].strip()
    first = out["windows"][0]
    emit("serve_autoscale", load=SERVE_AUTOSCALE, prompt_lens=[
        len(p) for p in prompts], new_tokens=len(want[0]),
         replica_start_s=out.get("replica_start_s"),
         scale_up_s=out["scale_up_s"], load_wall_s=out.get("load_s"),
         windows=len(out["windows"]), requests=total["requests"],
         ok=total["ok"], errors=total["errors"],
         tokens_per_s=tokens / total["wall_s"],
         ttft=first["ttft"], latency=first["latency"],
         achieved_rps=first["achieved_rps"],
         peak_inflight=first["peak_inflight"],
         later_windows=[{k: w[k] for k in ("requests", "ok", "wall_s",
                                            "achieved_rps", "ttft",
                                            "latency")}
                        for w in out["windows"][1:]],
         replicas={n: {k: p[k] for k in ("pid", "launches", "forwards",
                                         "device", "device_name", "init_s")}
                   for n, p in reps.items()},
         answers_wrong=out["answers_wrong"][:5],
         n_answers_wrong=len(out["answers_wrong"]),
         processes_left=out["processes_left"],
         note="run_load's TTFT and latency (s, host clock, from the "
              "scheduled send: a request that waits for one of the 8 "
              "connections counts that wait) over the first window; "
              "scale_up_s from the load's start to running_replicas 2; "
              "launches and forwards are each replica's own, zeroed after "
              "a first request and read after the load")
    problems = []
    if out.get("replicas_before") != 1:
        problems.append(f"{out.get('replicas_before')} replicas before the "
                        "load")
    if out["scale_up_s"] is None or len(reps) != 2:
        problems.append(f"running_replicas never reached 2: "
                        f"{out.get('status')}")
    for name, p in reps.items():
        if not p["launches"]["flash_fwd"] or \
                p["launches"]["flash_fwd"] != GPT2_124M["n_layer"] \
                * p["forwards"]:
            problems.append(f"{name}: flash_fwd {p['launches']} for "
                            f"{p['forwards']} forwards")
        if p["launches"]["flash_bwd_dq"] or p["launches"]["flash_bwd_dkv"]:
            problems.append(f"{name}: backward launches {p['launches']}")
        if p["device_name"] != card or p["pid"] == os.getpid():
            problems.append(f"{name}: on {p['device']} in pid {p['pid']}")
    if len({p["pid"] for p in reps.values()}) != len(reps):
        problems.append("two replicas in one process")
    if out["answers_wrong"] or total["ok"] != total["requests"] or \
            not total["ok"]:
        problems.append(f"{len(out['answers_wrong'])} wrong answers, "
                        f"{total['ok']} of {total['requests']} ok: "
                        f"{out['answers_wrong'][:2]}")
    if out["processes_left"]:
        problems.append(f"session processes left: {out['processes_left']}")
    if problems:
        raise AssertionError("serve_autoscale: " + "; ".join(problems))
    return launches


def _worker_entries(entries, train, serve):
    """``kernels`` rows of the paths that launch at phase 15's GPT-2 shapes
    in processes of their own (phases 33-35): for each (path, launches,
    whose) of ``train``, phase 15's entries at the training shape with
    those launches; of ``serve``, its ``flash_fwd`` entry at the serving
    shape. The times are phase 15's at that shape in the driver's
    process."""
    rows = []
    for entry in entries:
        if entry["path"] == "train":
            group = train
        elif entry["path"] == "serve" and entry["name"] == "flash_fwd":
            group = serve
        else:
            continue
        for path, launches, whose in group:
            rows.append(dict(entry, path=path,
                             launches=launches[entry["name"]],
                             note=f"launches {whose}; times are phase "
                                  "15's at this shape in the driver's "
                                  "process"))
    return rows


# phase 35: the durable train-then-serve workflow and the queue feeding the
# card (``tools/workflow_runs.py``), at phase 8's training and phase 6's
# serving configurations
WORKFLOW = {"device": "cuda", "num_gpus": 0.5, "steps": 4, "batch": 16,
            "seq": 1024,
            "train_model": {"preset": "gpt2_124m", "attention": "flash",
                            "loss_chunks": 8, "dtype": "bfloat16"},
            "serve_model": dict(GPT2_124M, attention="flash",
                                dtype="bfloat16"),
            "prompt_lens": [32, 129, 300, 512], "new_tokens": 16}


def workflow_queue_drive():
    """Phase 35's run, ``tools/workflow_runs.drive``, in a process of its
    own with a cluster of its own (this process's clusters belong to
    phases 28-31, beside which it runs), with the checks that take that
    process as the driver: (workdir, out, problems). The workdir holds the
    saved weights until ``phase_workflow_queue`` has decoded them."""
    import multiprocessing
    import shutil
    import tempfile

    from ray_tpu_torch.tools import workflow_runs

    workdir = tempfile.mkdtemp(prefix="workflow_")
    try:
        with concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            out, problems = pool.submit(
                workflow_runs.drive_checked, workdir, WORKFLOW,
                dict(num_cpus=4, num_gpus=1), GPT2_124M["n_layer"]).result()
    except BaseException:
        shutil.rmtree(workdir, ignore_errors=True)
        raise
    return workdir, out, problems


def phase_workflow_queue(smi, run, bf16_losses, bf16_streams):
    """Phase 35's checks on ``workflow_queue_drive``'s ``run``: a workflow
    trained GPT-2-124M in a worker, lost its driver to SIGKILL while an
    event step waited, and resumed to serve the saved weights in another
    worker; then a bounded queue fed phase 6's prompts, built by a ``Pool``
    of CPU workers, to a consumer actor on the card. The saved weights are
    decoded here. Returns the launches of the train step, the serve step
    and the consumer, each read in its own worker."""
    import shutil

    from ray_tpu_torch.tools import workflow_runs

    workdir, out, problems = run
    try:
        train, serve, q = out["train"], out["serve"], out["queue"]
        # a greedy decode of the saved weights in this process
        llm = workflow_runs.load_llm(WORKFLOW, train["weights"])
        _zero_launches()
        inproc = [workflow_runs.greedy(llm, p, WORKFLOW["new_tokens"])
                  for p in q["prompts"]]
        inproc_launches = _read_launches()
        del llm
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    steps = WORKFLOW["steps"]
    card = smi.split(",")[0].strip()
    emit("workflow_queue",
         config="train_step: gpt2_124m attention=flash loss_chunks=8 "
                "bf16/f32-params AdamW, 4 steps at 16 x 1024 from seed 0 on "
                "seed 1's batch; serve_step and the consumer: GPT2LLM bf16, "
                "4 prompts x 16 greedy tokens",
         train_step_s=train["seconds"], serve_step_s=serve["seconds"],
         first_run_to_checkpoint_s=out["first_run_s"],
         status_after_kill=out["status_after_kill"],
         kill_to_resume_s=out["kill_to_resume_s"],
         resumed_run_s=out["resume_s"], calls=out["calls"],
         losses=train["losses"], phase8_losses=bf16_losses[:steps],
         losses_equal_to_the_bit=train["losses"] == bf16_losses[:steps],
         train_launches=train["launches"], serve_launches=serve["launches"],
         serve_forwards=serve["forwards"], served_tokens=serve["tokens"],
         inproc_tokens=inproc, inproc_launches=inproc_launches,
         status=out["status"], listed=out["listed"],
         workers={"train": [train["pid"], train["device_name"]],
                  "serve": [serve["pid"], serve["device_name"]],
                  "consumer": [q["consumer"]["pid"],
                               q["consumer"]["device_name"]]},
         pool_s=q["pool_s"], consumer_start_s=q["consumer_start_s"],
         consumer_wait_s=q["consumer_wait_s"],
         third_put_refused=q["third_put_refused"],
         blocked_put_s=q["blocked_put_s"],
         queue_round_trip_s=q["round_trip_s"], queue_wall_s=q["wall_s"],
         consumer_launches=q["consumer"]["launches"],
         consumer_forwards=q["consumer"]["forwards"],
         processes_left=out["processes_left"],
         note="seconds on the host clock: each step's from its start in "
              "its worker to its return; first_run_to_checkpoint_s from "
              "the driver's start to the train step's checkpoint in "
              "storage; kill_to_resume_s from SIGKILL to the resume call; "
              "resumed_run_s that call; queue_round_trip_s from a "
              "prompt's put to its answer's put by the consumer")
    if train["losses"] != bf16_losses[:steps]:
        problems.append(f"losses {train['losses']} vs phase 8's "
                        f"{bf16_losses[:steps]}")
    if serve["tokens"] != inproc or out["output"]["tokens"] != inproc:
        problems.append("the served tokens differ from the in-process "
                        "decode of the saved weights")
    if q["prompts"] != phase6_prompts():
        problems.append("the pool's prompts differ from phase 6's")
    if q["tokens"] != [list(s) for s in bf16_streams[:4]]:
        problems.append(f"the consumer's tokens {q['tokens']} differ from "
                        "phase 6's streams")
    for name, (pid, dev) in {
            "train": (train["pid"], train["device_name"]),
            "serve": (serve["pid"], serve["device_name"]),
            "consumer": (q["consumer"]["pid"],
                         q["consumer"]["device_name"])}.items():
        if dev != card or pid == os.getpid():
            problems.append(f"{name} ran on {dev} in pid {pid}")
    if problems:
        raise AssertionError("workflow_queue: " + "; ".join(problems))
    return train["launches"], serve["launches"], q["consumer"]["launches"]


# phase 26: ring attention's blocks at GPT-2's training shape, bf16, the
# sequence in 4 chunks of 256 (numpy seed 26)
RING = {"b": 16, "h": 12, "s": 1024, "d": 64, "n": 4, "seed": 26}


def _ring_held(got, want, scales, dtype, extra=(None,) * 4):
    """Each of (out, dq, dk, dv) against ``want`` element by element at
    the ``TOLS`` of ``dtype``, the rtol term taken of |want| + the ring's
    partial magnitudes ``scales`` (None: of |want| alone), plus ``extra``'s
    term where it has one: {name: (ok, max abs error, largest share of the
    limit)}."""
    atol, rtol = TOLS[dtype]
    held = {}
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        g, w = got[i].float(), want[i].float()
        size = w.abs() if scales is None else w.abs() + scales[i]
        limit = atol + rtol * size
        if extra[i] is not None:
            limit = limit + extra[i]
        err = (g - w).abs()
        share = float((err / limit).max())
        held[name] = (share <= 1.0, float(err.max()), share)
    return held


def phase_ring_attention():
    """The ring's ranks played in one process (``tools/ring_runs.py``
    through ``ops.ring_attention``'s own per-rank loop), forward and
    backward, causal and not: out, dq, dk and dv against whole-sequence
    flash through the kernels (bf16, the ring's stated limit: the grads
    against flash's backward fed the ring's out, and against flash's own
    with the limit's delta terms), the same in f32 against the plain ring
    at f32 ``TOLS``, and the launches of the bf16 run (10 of each kernel
    causal, 16 not), each block's read around it. Returns those readings
    by block kind for the ``kernels`` line."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops.ring_attention import TOL_REASON as RING_REASON
    from ray_tpu_torch.tools import ring_runs, timing

    bh, s, d, n = RING["b"] * RING["h"], RING["s"], RING["d"], RING["n"]
    rng = np.random.default_rng(RING["seed"])
    f32 = [torch.from_numpy(rng.standard_normal((bh, s, d),
                                                dtype=np.float32)).cuda()
           for _ in range(4)]
    q, k, v, do = (t.to(torch.bfloat16) for t in f32)
    atol, rtol = TOLS[torch.bfloat16]
    fields, problems = {}, []
    by_kind = {kind: dict.fromkeys(KERNELS, 0) for kind in ("diag", "full")}
    for causal in (True, False):
        mode = "causal" if causal else "non_causal"
        torch.cuda.synchronize()
        _zero_launches()
        got, kinds = ring_runs.ring_fwd_bwd(q, k, v, do, n, causal,
                                            read=_read_launches)
        torch.cuda.synchronize()
        launches = _read_launches()
        for kind, counted in kinds.items():
            for name in KERNELS:
                by_kind[kind][name] += counted[name]
        scales = ring_runs.ring_magnitudes(q, k, v, do, n, causal)
        ref, lse = attn.flash_attention_fwd(q, k, v, causal=causal)
        # the backward at the ring's own delta: flash's fed the ring's out
        want = (ref, *attn.flash_attention_bwd(q, k, v, got[0], lse, do,
                                               causal=causal))
        own = (ref, *attn.flash_attention_bwd(q, k, v, ref, lse, do,
                                              causal=causal))
        held = _ring_held(got, want, scales, torch.bfloat16)
        plain_tols = _ring_held(got, want, None, torch.bfloat16)
        # against flash's own backward: the limit gains what the forward's
        # rounding carries into dq and dk through delta
        out_limit = atol + rtol * (ref.float().abs() + scales[0])
        terms = ring_runs.delta_terms(q, k, do, out_limit, causal)
        end_to_end = _ring_held(got, own, scales, torch.bfloat16,
                                extra=(None, *terms, None))
        del got, scales, want, own, ref, lse, out_limit, terms
        got32 = ring_runs.ring_fwd_bwd(*f32, n, causal)
        plain32 = ring_runs.ring_fwd_bwd(*f32, n, causal, plain=True)
        held32 = _ring_held(got32, plain32, None, torch.float32)
        del got32, plain32
        ring_ms = timing.time_ms(
            lambda: ring_runs.ring_fwd_bwd(q, k, v, do, n, causal), 10)
        q4, k4, v4 = (t.view(RING["b"], RING["h"], s, d).detach()
                      .requires_grad_() for t in (q, k, v))
        do4 = do.view(RING["b"], RING["h"], s, d)
        flash_ms = timing.time_ms(lambda: torch.autograd.grad(
            attn.flash_attention(q4, k4, v4, causal=causal), (q4, k4, v4),
            do4), 10)
        want_launches = dict.fromkeys(KERNELS,
                                      ring_runs.live_blocks(n, causal))
        summed = {name: sum(c[name] for c in kinds.values())
                  for name in KERNELS}
        result = lambda h: {key: {"max_abs_err": e, "share_of_limit": sh}
                            for key, (_, e, sh) in h.items()}
        fields[mode] = {
            "launches": launches, "want_launches": want_launches,
            "launches_by_block_kind": kinds,
            "bf16_vs_flash": result(held),
            "bf16_share_of_plain_tols": {key: sh for key, (_, _, sh)
                                         in plain_tols.items()},
            "bf16_vs_flash_own_delta": result(end_to_end),
            "f32_vs_plain_ring": result(held32),
            "ring_fwd_bwd_ms": ring_ms, "flash_attention_fwd_bwd_ms":
                flash_ms}
        if launches != want_launches or summed != launches:
            problems.append(f"{mode} launches {launches} (by block kind "
                            f"{kinds}), want {want_launches}")
        problems += [f"{mode} bf16 {key} off by {e} ({sh} of the limit)"
                     for key, (ok, e, sh) in held.items() if not ok]
        problems += [f"{mode} bf16 {key} off flash's own backward by {e} "
                     f"({sh} of the limit)"
                     for key, (ok, e, sh) in end_to_end.items() if not ok]
        problems += [f"{mode} f32 {key} off the plain ring by {e}"
                     for key, (ok, e, _) in held32.items() if not ok]
    emit("ring_attention", shape={"bh": bh, "s": s, "d": d, "chunks": n,
                                  "chunk": s // n, "dtype": "bfloat16"},
         **fields, tolerance={
             "bf16": {"atol": atol, "rtol": rtol,
                      "of": "|flash| + the partials' magnitudes",
                      "reason": RING_REASON,
                      "gated": "bf16_vs_flash (flash's backward fed the "
                               "ring's out) and bf16_vs_flash_own_delta "
                               "(flash's own, dq and dk with the delta "
                               "terms)"},
             "f32": _tol_fields(torch.float32)},
         note="ms by CUDA events: the ring composed in one process (all "
              "4 positions in turn) against flash_attention's forward and "
              "backward over the whole sequence")
    if problems:
        raise AssertionError("ring_attention: " + "; ".join(problems))
    return by_kind


# phase 27: the parallel steps at a world of one over NCCL, on phase 8's
# configuration, weights and batch (GPT-2), phase 17's (the MoE LM) and
# phase 10's (Llama-2-7B)
PARALLEL = {"steps": 5, "microbatches": 4}


def phase_parallel_train(bf16_losses, bf16_step_ms, moe_train,
                         llama_tokens):
    """``build_train_step_sp`` (ring attention), ``build_train_step_pp``
    (4 microbatches) and ``shard_train_state_tp`` on GPT-2-124M, 5 steps
    each; ``shard_train_state_ep`` on ``MoELMConfig()``, 5 steps; and
    Llama-2-7B through ``shard_params_tp``/``apply_tp_plan`` and
    ``generate`` (``shard_kv_caches_tp``): each on a mesh of size-1 axes
    in a process group of this process alone over NCCL. Checks: every loss
    within 1e-2 of phase 8's (GPT-2) or phase 17's (the MoE LM) at that
    step, Llama's tokens equal to phase 10's, and each step's launches (12
    of each kernel for SP, TP and EP, 48 for PP; 1,024 ``flash_fwd`` and no
    backward for Llama, 32 of them in the prefill and 992 in the decode
    steps, each read around its part as ``llama_runs.time_steps`` runs them
    again on the tokens)."""
    import gc

    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2, llama, moe_lm
    from ray_tpu_torch.tools import llama_runs, parallel_runs, train_runs

    steps, M = PARALLEL["steps"], PARALLEL["microbatches"]
    counts = (_zero_launches, _read_launches)
    layers = GPT2_124M["n_layer"]
    per_step = {"sp": layers, "tp": layers, "pp": layers * M, "ep": layers}
    runs = {}
    with parallel_runs.world_of_one("nccl"):
        backend = dist.get_backend()
        cfg = train_runs.bf16_config()
        batch = gpt2.synthetic_batch(1, train_runs.BATCH, train_runs.SEQ,
                                     cfg.vocab_size)
        for kind in ("sp", "pp", "tp"):
            runs[kind] = parallel_runs.gpt2_steps(kind, cfg, batch, steps,
                                                  "cuda", microbatches=M,
                                                  counts=counts)
            gc.collect()
            torch.cuda.empty_cache()
        del batch
        mcfg = moe_lm.MoELMConfig()
        mbatch = gpt2.synthetic_batch(60, MOE["batch"], MOE["seq"],
                                      mcfg.vocab_size)
        runs["ep"] = parallel_runs.moe_ep_steps(mcfg, mbatch, steps, "cuda",
                                                MOE["lr"], counts)
        del mbatch
        gc.collect()
        torch.cuda.empty_cache()
        B, T, new = (LLAMA_SERVE[k] for k in ("batch", "prompt",
                                               "new_tokens"))
        lcfg = llama.LlamaConfig.llama2_7b()
        model = llama.init_params(lcfg, _cuda_gen(20))  # phase 10's
        llama.cast_for_serving(model, torch.bfloat16)
        prompts = llama_runs.prompts(21, B, T, lcfg.vocab_size, "cuda")
        llama.generate(model, prompts[:, :16], 2)  # cuBLAS and the library
        served = parallel_runs.llama_tp_generate(model, prompts, new, counts)
        tp_heads = model.h[0].attn.k_proj.weight.shape[0] // lcfg.head_dim
        del model, prompts
        gc.collect()
        torch.cuda.empty_cache()

    problems = []
    if backend != "nccl":
        problems.append(f"backend {backend}")
    wants = {"sp": bf16_losses, "pp": bf16_losses, "tp": bf16_losses,
             "ep": moe_train[2]}
    fields = {}
    for kind, run in runs.items():
        diffs = [abs(a - b) for a, b in zip(run["losses"], wants[kind])]
        want_launches = dict.fromkeys(KERNELS, per_step[kind])
        median = statistics.median(run["step_ms"][1:])
        fields[kind] = {"losses": run["losses"], "max_loss_diff": max(diffs),
                        "step_ms": run["step_ms"],
                        "step_ms_median_after_first": median,
                        "launches_per_step": run["launches"]}
        if kind == "ep":
            fields[kind].update(lm=run["lm"], aux=run["aux"])
        if not (all(math.isfinite(x) for x in run["losses"])
                and max(diffs) <= 1e-2):
            problems.append(f"{kind} losses {run['losses']} vs "
                            f"{wants[kind][:steps]}")
        if any(x != want_launches for x in run["launches"]):
            problems.append(f"{kind} launches {run['launches']}, want "
                            f"{want_launches} a step")
    want_llama = {"flash_fwd": lcfg.n_layer * new, "flash_bwd_dq": 0,
                  "flash_bwd_dkv": 0}
    want_prefill = dict(want_llama, flash_fwd=lcfg.n_layer)
    want_decode = dict(want_llama, flash_fwd=lcfg.n_layer * (new - 1))
    tokens_equal = torch.equal(served["tokens"].cpu(), llama_tokens)
    fields["llama_tp"] = {"generate_s": served["generate_s"],
                          "tokens_per_s": B * new / served["generate_s"],
                          "launches": served["launches"],
                          "prefill_launches": served["prefill_launches"],
                          "decode_launches": served["decode_launches"],
                          "kv_heads_per_rank": tp_heads,
                          "tokens_sha256": _digest(served["tokens"]),
                          "tokens_equal_phase_10": tokens_equal}
    if not tokens_equal:
        problems.append("Llama's TP tokens differ from phase 10's")
    for part, want in (("launches", want_llama),
                       ("prefill_launches", want_prefill),
                       ("decode_launches", want_decode)):
        if served[part] != want:
            problems.append(f"llama_tp {part} {served[part]}, want {want}")
    emit("parallel_train", backend=backend,
         meshes=parallel_runs.MESHES, steps=steps, microbatches=M,
         **fields, phase_8_step_ms=bf16_step_ms,
         phase_17_step_ms_median=moe_train[1],
         tolerance={"losses": "1e-2 of phase 8's (GPT-2) or 17's (MoE) at "
                    "each step", "llama": "tokens equal to phase 10's"},
         note="step ms on the host clock to a sync, each step alone; "
              "phase 8's is its mean over 10 timed steps")
    if problems:
        raise AssertionError("parallel_train: " + "; ".join(problems))
    return {kind: {name: sum(x[name] for x in run["launches"])
                   for name in KERNELS} for kind, run in runs.items()} | {
        "llama_tp_prefill": served["prefill_launches"],
        "llama_tp_decode": served["decode_launches"],
        "pp_step_ms": fields["pp"]["step_ms_median_after_first"]}


# Phase 36: the port's data plane under a gang. Two ranks share the card at
# half a GPU each and take phase 8's batch of 16 in halves of 8 rows; f32
# losses within phase 8's 1e-2 (phases 27 and 33), int8 within 5e-2
# (phase 20's quantized fit). Rank 0's reduced step-1 gradient came within
# 0.0772 of the whole batch's on the H100 (80GB HBM3, 700 W; h.9.ln_1.bias,
# worst of 148), as the mean of the ranks' own gradients taken in one
# process does, to the bit: bf16 products summed over half the rows. A sum
# is 0.90-1.04 off and no reduction up to 0.99, so "grad_limit" is 0.2. The
# reduced gradient equals that in-process mean to the bit on the H100 and
# on the CPU; "halves_limit" leaves room for an f32 sum in another order.
GANG = {"ranks": 2, "gpu": 0.5, "rows": 8, "steps": {"f32": 2, "int8": 2},
        "f32_limit": 1e-2, "int8_limit": 5e-2, "grad_limit": 0.2,
        "halves_limit": 1e-6}


def _state_digest(state):
    """sha256 over a {name: tensor or numpy array} state: each name, dtype,
    shape and byte, names in order."""
    h = hashlib.sha256()
    for name in sorted(state):
        v = state[name]
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        h.update(f"{name}:{arr.dtype}:{arr.shape};".encode())
        h.update(memoryview(np.ascontiguousarray(arr)).cast("B"))
    return h.hexdigest()


class ObjectWriter:
    """Phase 36 (a)'s writer: GPT-2's parameters from phase 8's seed on its
    device, put twice, as a dict of tensors and as a dict of numpy arrays.
    The puts are made here, so the memory summary names this file as their
    call site."""

    def build(self, model, device):
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.tools import gang_runs

        net = gpt2.init_params(gang_runs._config(model),
                               torch.Generator().manual_seed(0),
                               device=device)
        self.state = {n: p.detach() for n, p in net.named_parameters()}
        self.device = torch.device(device)
        self.refs = None
        return {"digest": _state_digest(self.state),
                "params": sum(t.numel() for t in self.state.values()),
                "bytes": sum(t.numel() * t.element_size()
                             for t in self.state.values()),
                "device": str(next(iter(self.state.values())).device),
                "pid": os.getpid()}

    def put_both(self):
        import ray_tpu_torch as rt

        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        tensors = rt.put(self.state)
        put_tensors_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = {n: t.cpu().numpy() for n, t in self.state.items()}
        to_host_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        arrays = rt.put(host)
        put_numpy_s = time.perf_counter() - t0
        self.refs = [tensors, arrays]
        return {"refs": [tensors, arrays], "put_tensors_s": put_tensors_s,
                "to_host_s": to_host_s, "put_numpy_s": put_numpy_s}

    def torch_pickle(self):
        """A small tensor on this device as torch itself pickles it."""
        import pickle

        return pickle.dumps(torch.arange(4.0, device=self.device))

    def drop(self):
        self.refs = None
        return True


class ObjectReader:
    """Phase 36 (a)'s reader: ``get`` of both forms, timed, each digested;
    which device the tensors land on, whether the arrays are writeable."""

    def read(self, refs):
        import ray_tpu_torch as rt

        card = torch.cuda.is_available()
        out = {"pid": os.getpid(), "card_visible": card}
        t0 = time.perf_counter()
        got = rt.get(refs[0], timeout=300)
        if card:
            torch.cuda.synchronize()
        out["get_tensors_s"] = time.perf_counter() - t0
        out["tensor_devices"] = sorted({t.device.type for t in got.values()})
        out["tensor_types"] = sorted({type(t).__name__ for t in got.values()})
        out["tensor_digest"] = _state_digest(got)
        del got
        t0 = time.perf_counter()
        arrays = rt.get(refs[1], timeout=300)
        out["get_numpy_s"] = time.perf_counter() - t0
        out["numpy_types"] = sorted({type(a).__name__
                                     for a in arrays.values()})
        # the store keeps buffers of 512 bytes and more out of band, and
        # hands those back as read-only views of its memory
        out["numpy_writeable"] = sum(a.flags.writeable and a.nbytes >= 512
                                     for a in arrays.values())
        out["numpy_in_band"] = sum(a.nbytes < 512 for a in arrays.values())
        out["numpy_digest"] = _state_digest(arrays)
        del arrays
        return out

    def load_torch_pickle(self, blob):
        import pickle

        try:
            return {"raised": None, "device": str(pickle.loads(blob).device)}
        except Exception as e:  # what torch's own pickle does here
            return {"raised": f"{type(e).__name__}: {e}"[:300]}


def gang_objects(model="gpt2_124m", device="cuda", card_gpu=GANG["gpu"]):
    """Phase 36 (a) in a running cluster: (fields, problems). A writer
    actor at ``card_gpu`` of a card builds ``model``'s parameters on
    ``device`` and puts both forms; a second card actor, the driver and an
    actor at ``num_gpus=0`` with the card hidden read them. ``card_gpu=0``
    and ``device="cpu"`` rehearse it on the CPU."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import state

    on_card = device != "cpu"
    writer = rt.remote(num_gpus=card_gpu)(ObjectWriter).remote()
    card_reader = rt.remote(num_gpus=card_gpu)(ObjectReader).remote()
    hidden = rt.remote(num_gpus=0, runtime_env={"env_vars": {
        "CUDA_VISIBLE_DEVICES": ""}})(ObjectReader).remote()
    t0 = time.perf_counter()
    built = rt.get(writer.build.remote(model, device), timeout=300)
    build_s = time.perf_counter() - t0
    put = rt.get(writer.put_both.remote(), timeout=300)
    refs = put.pop("refs")
    # the three readers read at once: each one's GB/s is under the others'
    t0 = time.perf_counter()
    pending = {"card_actor": card_reader.read.remote(refs),
               "hidden_actor": hidden.read.remote(refs)}
    reads = {"driver": ObjectReader().read(refs)}
    reads.update({name: rt.get(ref, timeout=300)
                  for name, ref in pending.items()})
    reads_s = time.perf_counter() - t0
    torch_pickle = rt.get(hidden.load_torch_pickle.remote(
        rt.get(writer.torch_pickle.remote(), timeout=60)), timeout=60)
    ids = [r.binary().hex() for r in refs]
    summary = state.object_summary(group_by="callsite")
    rows = {r["object_id"]: r for r in summary["objects"]}
    listed = {oid: {"state": rows[oid]["state"], "size": rows[oid]["size"],
                    "callsite": rows[oid].get("callsite")}
              for oid in ids if oid in rows}
    del refs
    rt.get(writer.drop.remote(), timeout=60)
    t0 = time.perf_counter()
    deadline = time.time() + 60
    left = ids
    while left and time.time() < deadline:
        present = {r["object_id"] for r in
                   state.object_summary()["objects"]}
        left = [oid for oid in ids if oid in present]
        if left:
            time.sleep(0.5)
    freed_s = time.perf_counter() - t0
    for actor in (writer, card_reader, hidden):
        rt.kill(actor)
    nbytes = built["bytes"]
    gbps = lambda s: nbytes / s / 1e9
    fields = {
        "params": built["params"], "bytes": nbytes,
        "writer_device": built["device"], "build_s": build_s,
        "reads_s": reads_s,
        "put_tensors_s": put["put_tensors_s"],
        "put_tensors_gb_per_s": gbps(put["put_tensors_s"]),
        "to_host_s": put["to_host_s"], "put_numpy_s": put["put_numpy_s"],
        "put_numpy_gb_per_s": gbps(put["put_numpy_s"]),
        "reads": {name: dict(
            r, get_tensors_gb_per_s=gbps(r["get_tensors_s"]),
            get_numpy_gb_per_s=gbps(r["get_numpy_s"]))
            for name, r in reads.items()},
        "torch_pickle_in_hidden_reader": torch_pickle,
        "summary_rows": listed, "freed_after_s": freed_s,
        "left_in_store": left}
    problems = []
    card_type = "cuda" if on_card else "cpu"
    if built["device"].split(":")[0] != card_type:
        problems.append(f"the writer built on {built['device']}")
    for name, r in reads.items():
        if r["tensor_digest"] != built["digest"]:
            problems.append(f"{name}: the tensors read differ from those put")
        if r["numpy_digest"] != built["digest"]:
            problems.append(f"{name}: the arrays read differ from those put")
        if r["numpy_writeable"]:
            problems.append(f"{name}: {r['numpy_writeable']} arrays are "
                            "writeable (not zero-copy reads)")
        want = "cpu" if name == "hidden_actor" else card_type
        if r["tensor_devices"] != [want] or r["tensor_types"] != ["Tensor"]:
            problems.append(f"{name}: tensors {r['tensor_types']} on "
                            f"{r['tensor_devices']}, want Tensor on {want}")
    if reads["hidden_actor"]["card_visible"]:
        problems.append("the hidden reader sees a card")
    if on_card and not reads["card_actor"]["card_visible"]:
        problems.append("the card reader sees no card")
    if on_card and torch_pickle["raised"] is None:
        problems.append("torch's own pickle of a CUDA tensor loaded where the "
                        f"card is hidden: {torch_pickle}")
    for oid in ids:
        row = listed.get(oid)
        if row is None or "chip_smoke.py" not in (row["callsite"] or ""):
            problems.append(f"the memory summary lists {oid} as {row}")
    if left:
        problems.append(f"the store still holds {left} after the refs went")
    return fields, problems


def gang_gradsync(root, model="gpt2_124m", device="cuda", seq=None,
                  resources=None, use_gpu=True, chunk_bytes=None,
                  rows=GANG["rows"]):
    """Phase 36 (b) in a running cluster: the f32 fit and the int8 fit of
    ``tools/gang_runs.gradsync_loop``; returns both fits' results, the int8
    bound's (fields, problems) and step-1 gradient gaps
    (``gang_runs.grad_gaps``) to the whole batch's gradient taken here in
    one process: "mean" of rank 0's reduced gradient, "sum" and "rank0" of
    what a reduction that sums or none would have left it, "halves" of the
    mean of each rank's gradient taken here; and "mean_vs_halves", the
    reduced gradient against that mean."""
    import torch

    from ray_tpu_torch.tools import gang_runs, train_runs

    resources = resources or {"CPU": 1, "GPU": GANG["gpu"]}
    seq = seq or train_runs.SEQ
    base = dict(model=model, device=device, rows=rows, seq=seq,
                ranks=GANG["ranks"], chunk_bytes=chunk_bytes)
    ref_path = os.path.join(root, "f32", "f32_step1.pt")
    fits = {}
    for name, quant in (("f32", ""), ("int8", "int8")):
        config = dict(base, out_dir=os.path.join(root, name),
                      steps=GANG["steps"][name],
                      capture="int8" if quant else "reduced",
                      ref_path=ref_path)
        fits[name] = gang_runs.gradsync_fit(
            config, quant, resources, use_gpu, f"gang_{name}")
    bound = gang_runs.int8_bound_problems(os.path.join(root, "int8"),
                                          GANG["ranks"])
    reduced = torch.load(ref_path)
    grads = gang_runs.step1_grads(model, device, seq, rows, GANG["ranks"])
    whole, ranks = grads["whole"], grads["ranks"]
    halves = {n: sum(g[n] for g in ranks) / len(ranks) for n in whole}
    gaps = {"mean": gang_runs.grad_gaps(reduced, whole),
            "sum": gang_runs.grad_gaps(
                {n: 2 * r for n, r in reduced.items()}, whole),
            "rank0": gang_runs.grad_gaps(ranks[0], whole),
            "halves": gang_runs.grad_gaps(halves, whole),
            "mean_vs_halves": gang_runs.grad_gaps(reduced, halves)}
    return fits, bound, gaps


def _gang_problems(fits, bound, gaps, grad_limit, bf16_losses, n_layer,
                   card):
    """The checks of phase 36 (b) on ``gang_gradsync``'s results: (fields,
    problems). Rank 0's reduced step-1 gradient lies within ``grad_limit``
    of the whole batch's, per parameter, and a sum or no reduction would
    not ("sum", "rank0"); it lies within ``GANG["halves_limit"]`` of the
    mean of the ranks' own gradients taken in one process."""
    from ray_tpu_torch.tools import gang_runs

    fields, problems = {}, list(bound[1])
    worst = {k: max(g.items(), key=lambda kv: kv[1]) for k, g in gaps.items()}
    fields["reduced_vs_whole_step1"] = {
        "limit": grad_limit, "params_checked": len(gaps["mean"]),
        **{f"worst_{k}": {"param": n, "rel_err": e}
           for k, (n, e) in worst.items()}}
    problems += [f"{n}: reduced step-1 gradient {e} off the whole batch's "
                 f"(limit {grad_limit})" for n, e in gaps["mean"].items()
                 if not e <= grad_limit]
    problems += [f"{n}: reduced step-1 gradient {e} off the mean of the "
                 f"ranks' own (limit {GANG['halves_limit']})"
                 for n, e in gaps["mean_vs_halves"].items()
                 if not e <= GANG["halves_limit"]]
    problems += [f"the gradient check would pass a reduction giving {k}: "
                 f"worst {worst[k][1]} within {grad_limit}"
                 for k in ("sum", "rank0") if not worst[k][1] > grad_limit]
    for name, fit in fits.items():
        recs = fit["records"]
        steps = GANG["steps"][name]
        losses = [statistics.fmean(r[i]["loss"] for r in recs)
                  for i in range(steps)]
        gap = max(abs(a - b) for a, b in zip(losses, bf16_losses))
        limit = GANG["f32_limit"] if name == "f32" else GANG["int8_limit"]
        missing = [row["seq"] for row in fit["rows"] if row["missing"]]
        launches = [r[-1]["launches"] for r in recs]
        fields[name] = {
            "losses": losses, "rank_losses": [[x["loss"] for x in r]
                                              for r in recs],
            "max_loss_gap_vs_phase8": gap,
            "step_ms": [[x["step_ms"] for x in r] for r in recs],
            "allreduce_s": [[x["allreduce_s"] for x in r] for r in recs],
            "exposed_allreduce_s": [[x["exposed_s"] for x in r]
                                    for r in recs],
            **{f"{k}_bytes": v for k, v in
               gang_runs.wire_bytes(fit["rows"]).items()},
            "collectives": len(fit["rows"]), "chunks": len(fit["chunks"]),
            "missing_ranks": len(missing),
            "overlap": gang_runs.overlapped(fit["rows"], fit["compute"]),
            "launches": launches, "pids": [r[0]["pid"] for r in recs],
            "devices": [r[0]["device_name"] for r in recs],
            "reduced_type": recs[0][0]["reduced_type"],
            "fit_wall_s": fit["wall_s"]}
        f = fields[name]
        if not (all(math.isfinite(x) for x in losses) and gap <= limit):
            problems.append(f"{name}: losses {losses} vs phase 8's "
                            f"{bf16_losses[:steps]} (limit {limit})")
        if not fit["rows"] or not fit["chunks"] or missing:
            problems.append(f"{name}: {len(fit['rows'])} train_dp rows, "
                            f"{len(fit['chunks'])} chunk records, missing "
                            f"ranks at seqs {missing[:5]}")
        if not f["overlap"]:
            problems.append(f"{name}: no collective overlaps its rank's "
                            "compute phase")
        want = dict.fromkeys(KERNELS, n_layer * steps)
        if any(x != want for x in launches):
            problems.append(f"{name}: launches {launches}, want {want} in "
                            "each worker")
        if len(set(f["pids"])) != GANG["ranks"] or os.getpid() in f["pids"]:
            problems.append(f"{name}: worker pids {f['pids']}")
        if any(d != card for d in f["devices"]):
            problems.append(f"{name}: worker devices {f['devices']}, not "
                            f"{card!r}")
        if f["reduced_type"] != "ndarray":
            problems.append(f"{name}: the store path returned "
                            f"{f['reduced_type']}")
    if not fields["int8"]["wire_bytes"] < fields["int8"]["logical_bytes"]:
        problems.append(f"int8 wire {fields['int8']['wire_bytes']} is not "
                        f"below its logical {fields['int8']['logical_bytes']}")
    fields["int8_vs_f32_step1"] = bound[0]
    return fields, problems


def _nccl_problems(ops):
    """Phase 36 (c): the "nccl" backend's four ops of phase 20's quantized
    fit (``_nccl_collective_ops``)."""
    problems = []
    for op, r in ops.items():
        if not (r["on_card"] and r["equal_store"]):
            problems.append(f"nccl {op}: {r}")
        if op in ("allreduce", "broadcast") and not r["in_place"]:
            problems.append(f"nccl {op} did not reduce in place: {r}")
    if sorted(ops) != ["allgather", "allreduce", "broadcast",
                       "reducescatter"]:
        problems.append(f"nccl ops run: {sorted(ops)}")
    return problems


def phase_gang_data_plane(smi, bf16_losses, nccl_ops):
    """Phase 36: the object plane, GradSync's chunked allreduce over the
    store with two ranks sharing the card, and the "nccl" backend's ops
    (run inside phase 20's quantized fit, ``nccl_ops``). Returns each
    worker's launches, for the ``kernels`` line."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    if __name__ != "__main__":
        # imported by a short script: send the actors by value all the same
        import cloudpickle

        cloudpickle.register_pickle_by_value(sys.modules[__name__])
    card = smi.split(",")[0].strip()
    root = tempfile.mkdtemp(prefix="gang_")
    seconds, t0 = {}, time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1)
    session_dir = global_worker.node.session_dir
    try:
        seconds["init"], t0 = time.perf_counter() - t0, time.perf_counter()
        objects, problems = gang_objects()
        seconds["objects"], t0 = time.perf_counter() - t0, time.perf_counter()
        fits, bound, gaps = gang_gradsync(root)
        seconds["gradsync"], t0 = time.perf_counter() - t0, time.perf_counter()
        gang, more = _gang_problems(fits, bound, gaps, GANG["grad_limit"],
                                    bf16_losses, GPT2_124M["n_layer"], card)
        problems += more
        trace = state.train_timeline(os.path.join(root, "timeline.json"))
        with open(os.path.join(root, "timeline.json")) as f:
            written = json.load(f)
        seconds["timeline"], t0 = time.perf_counter() - t0, time.perf_counter()
    finally:
        rt.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    left = _wait_for_no_processes(session_dir)
    seconds["shutdown"] = time.perf_counter() - t0
    ranks = {e["args"]["name"] for e in trace if e["ph"] == "M"}
    problems += _nccl_problems(nccl_ops)
    if written != trace or not {"rank 0", "rank 1"} <= ranks:
        problems.append(f"train_timeline: process rows {sorted(ranks)}")
    if left:
        problems.append(f"session processes left after shutdown: {left}")
    steps = GANG["steps"]
    emit("gang_data_plane", objects=objects, gradsync=gang,
         nccl_ops=nccl_ops, seconds=seconds, timeline_events=len(trace),
         timeline_ranks=sorted(ranks), processes_left=left,
         config="gpt2_124m attention=flash loss_chunks=8 bf16/f32-params "
                f"AdamW lr 3e-4, {GANG['ranks']} ranks at GPU "
                f"{GANG['gpu']} on one card, {GANG['rows']} x 1024 rows "
                f"each, {steps['f32']} steps (int8: {steps['int8']}), "
                "TorchConfig(backend='gloo'), "
                "overlap_grads=True, GradSync mean over the store "
                "collective's train_dp group (collective_chunk_bytes "
                "default), then collective_quant='int8'",
         note="step_ms on each worker's host clock; allreduce_s from the "
              "first gradient's submit to the reduced gradients, "
              "exposed_allreduce_s from the end of the backward (synced) "
              "to them; wire/logical bytes summed over the ranks' "
              "collective records; GB/s over the parameters' f32 bytes")
    if problems:
        raise AssertionError("gang_data_plane: " + "; ".join(problems))
    return {name: [r[-1]["launches"] for r in fit["records"]]
            for name, fit in fits.items()}


def _bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak of their type (bf16 on the tensor cores unless
    another is given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _live_pairs(bh, sq, sk, causal):
    """(query, key) pairs the causal mask leaves live: the work these
    inputs need."""
    if not causal:
        return bh * sq * sk
    return bh * sum(max(0, min(sk, i + sk - sq + 1)) for i in range(sq))


# the aten op through which SDPA dispatches to each of its backends
SDPA_OPS = {"flash": "_scaled_dot_product_flash_attention",
            "efficient": "_scaled_dot_product_efficient_attention",
            "cuDNN": "_scaled_dot_product_cudnn_attention",
            "math": "_scaled_dot_product_attention_math"}


def _sdpa_error(out, ref):
    """SDPA's own output against the plain reference ``ref``, at the bf16
    limit: its max abs error and largest share of the limit."""
    _, err, share = _close(out.detach().reshape(ref.shape).float(), ref,
                           *TOLS[torch.bfloat16])
    return {"library_max_abs_err": err, "library_err_share_of_limit": share}


def _sdpa_profile(fn, suffix=""):
    """From the profiler, over 20 calls of the SDPA call ``fn``: the backend
    it dispatched to (the aten op, + ``suffix``), its CUDA kernels and their
    device time per call."""
    from ray_tpu_torch.tools import timing

    ops, kernels, device_ms = timing.profile_calls(fn, 20)
    ran = [b for b, op in SDPA_OPS.items() if any(op + suffix in x
                                                   for x in ops)]
    return {"library_backend": ",".join(ran) or "not measured",
            "library_kernels": kernels[:6], "library_device_ms": device_ms}


def _entry(name, launches, err, ms, plain_ms, bound, library_ms, flops,
           design, **extra):
    """One kernel's entry of the ``kernels`` line; ``flops`` are the live
    pairs' FLOPs, which give its rate in TFLOP/s."""
    return {"name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms, "tflops": flops / (ms * 1e-3) / 1e12,
            "design": design, **extra}


def _fwd_shape_entry(launches, path, bh, sq, sk, d, seed, k_len=None):
    """flash_fwd at one shape of a serving path (causal, bf16; with a live
    length ``k_len`` over Sk rows where the path gives one): (entry, a
    function giving the entry's profiler fields, to run after every
    CUDA-event timing)."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools import timing

    live = sk if k_len is None else k_len
    if sq not in (1, live):
        raise ValueError(f"no SDPA yardstick for causal Sq {sq} < {live}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for s in (sq, sk, sk))
    dev_len = None if k_len is None else torch.tensor(
        k_len, dtype=torch.int32, device="cuda")
    kw = dict(causal=True, k_len=dev_len)
    scale = d ** -0.5
    out, _ = attn.flash_attention_fwd(q, k, v, **kw)
    ref, _ = attn._flash_plain(q.float(), k.float(), v.float(),
                               sm_scale=scale, **kw)
    ok, err, share = _close(out.float(), ref, *TOLS[torch.bfloat16])
    fwd = lambda: attn.flash_attention_fwd(q, k, v, **kw)
    ms = timing.time_ms(fwd, 100)
    plain_ms = timing.time_ms(lambda: attn._flash_plain(
        q, k, v, sm_scale=scale, **kw), 20)
    # SDPA over the live rows (a view of the same k and v): its is_causal
    # aligns top-left, the kernel bottom-right, the same mask at Sq = live;
    # at Sq = 1 the one query sees every live key, so SDPA runs without a
    # mask there
    q4, k4, v4 = (t[None] for t in (q, k[:, :live], v[:, :live]))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=sq == live)
    library_ms = timing.time_ms(sdpa, 100)
    sdpa_error = _sdpa_error(sdpa(), ref)
    profile = lambda: {**_launch_profile(fwd), **_sdpa_profile(sdpa)}
    # q and the live rows of k and v read once, out (bf16) and lse (f32)
    # written once; QK^T and PV over the live pairs
    nbytes = (2 * sq + 2 * live) * bh * d * 2 + bh * sq * 4
    flops = 4 * _live_pairs(bh, sq, live, True) * d
    if not ok:
        raise AssertionError(f"flash_fwd at the {path} shape: error {err}, "
                             f"{share} of its limit")
    return _entry("flash_fwd", launches, err, ms, plain_ms,
                  _bound(nbytes, flops), library_ms, flops,
                  attn.fwd_design(torch.bfloat16), path=path,
                  tolerance=_tol_fields(torch.bfloat16),
                  err_share_of_limit=share, library="torch SDPA forward",
                  **sdpa_error,
                  shape={"bh": bh, "sq": sq, "sk": sk, "k_len": k_len,
                         "d": d, "causal": True, "dtype": "bfloat16"}), profile


def _launch_profile(fn, iters=20):
    """A wrapper's one kernel a call under the profiler: ``device_ms``, the
    mean of the records it kept, and ``device_records``, their number of
    ``iters`` launches (the profiler has kept fewer in some runs, which
    made a sum over the calls read low)."""
    from ray_tpu_torch.tools import timing

    ms, records = timing.launch_ms(fn, iters)
    return {"device_ms": ms, "device_records": records,
            "device_launches": iters}


def _train_shape_entries(launches, step_ms, path, b, h, s, d, n_layer,
                         seed, causal=True):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv at the shape a training
    path gives them (batch b x h heads, seq s, head dim d, causal or not,
    bf16):
    (entries, attention's share of the step of ``n_layer`` launches of each
    (None without a ``step_ms``), a function giving each entry's profiler
    fields by name, to run after every CUDA-event timing)."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tools import timing

    bh, n = b * h, b * h * s * d
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda"
                               ).to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    kw = dict(causal=causal, sm_scale=scale)
    out, lse = attn.flash_attention_fwd(q, k, v, causal=causal)
    delta = attn._delta(out, do)
    # errors against the plain versions in f32 on the same rounded inputs
    f32 = [t.float() for t in (q, k, v, do)]
    ref_out, _ = attn._flash_plain(*f32[:3], **kw)
    ref_dq = attn._bwd_dq_plain(*f32, lse, delta, block_q=64, block_k=64,
                                **kw)
    ref_dk, ref_dv = attn._bwd_dkv_plain(*f32, lse, delta, block_q=64,
                                         block_k=64, **kw)
    dq = attn._flash_bwd_dq_kernel(q, k, v, do, lse, delta, **kw)
    dk, dv = attn._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **kw)
    # element by element at the bf16 tolerance of the kernel-vs-plain phases
    pairs = {"flash_fwd": ((out, ref_out),), "flash_bwd_dq": ((dq, ref_dq),),
             "flash_bwd_dkv": ((dk, ref_dk), (dv, ref_dv))}
    tol = TOLS[torch.bfloat16]
    held = {name: [_close(g.float(), r, *tol) for g, r in ps]
            for name, ps in pairs.items()}
    errs = {name: max(h[1] for h in hs) for name, hs in held.items()}
    shares = {name: max(h[2] for h in hs) for name, hs in held.items()}
    # no atomics, a fixed order of sums: a second launch gives the same bits
    again = {"flash_bwd_dq": (attn._flash_bwd_dq_kernel(
                 q, k, v, do, lse, delta, **kw),),
             "flash_bwd_dkv": attn._flash_bwd_dkv_kernel(
                 q, k, v, do, lse, delta, **kw)}
    first = {"flash_bwd_dq": (dq,), "flash_bwd_dkv": (dk, dv)}
    same_bits = {name: all(torch.equal(a, b) for a, b in
                           zip(first[name], again[name])) for name in first}
    del f32, pairs, ref_dq, ref_dk, ref_dv, dq, dk, dv, again, first

    ms = {"flash_fwd": timing.time_ms(lambda: attn.flash_attention_fwd(
              q, k, v, causal=causal), 20),
          "flash_bwd_dq": timing.time_ms(lambda: attn._flash_bwd_dq_kernel(
              q, k, v, do, lse, delta, **kw), 10),
          "flash_bwd_dkv": timing.time_ms(lambda: attn._flash_bwd_dkv_kernel(
              q, k, v, do, lse, delta, **kw), 10)}
    delta_ms = timing.time_ms(lambda: attn._delta(out, do), 20)
    plain_ms = {"flash_fwd": timing.time_ms(lambda: attn._flash_plain(
                    q, k, v, **kw), 3),
                "flash_bwd_dq": timing.time_ms(lambda: attn._bwd_dq_plain(
                    q, k, v, do, lse, delta, block_q=64, block_k=64,
                    **kw), 3),
                "flash_bwd_dkv": timing.time_ms(lambda: attn._bwd_dkv_plain(
                    q, k, v, do, lse, delta, block_q=64, block_k=64,
                    **kw), 3)}
    # yardsticks: SDPA's forward, and its backward as (forward + backward)
    # minus forward, both with grad enabled
    q4, k4, v4 = (t.view(b, h, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    do4 = do.view(b, h, s, d)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal)
    sdpa_fwd_bwd = lambda: torch.autograd.grad(sdpa(), (q4, k4, v4), do4)
    sdpa_error = _sdpa_error(sdpa(), ref_out)
    del ref_out
    sdpa_fwd_ms = timing.time_ms(sdpa, 20)
    sdpa_bwd_ms = timing.time_ms(sdpa_fwd_bwd, 20) - sdpa_fwd_ms

    def profile():
        fwd = _sdpa_profile(sdpa)
        bwd = _sdpa_profile(sdpa_fwd_bwd, "_backward")
        if None not in (fwd["library_device_ms"], bwd["library_device_ms"]):
            bwd["library_device_ms"] -= fwd["library_device_ms"]
        flash = _launch_profile(lambda: attn.flash_attention_fwd(
            q, k, v, causal=causal))
        dq = _launch_profile(lambda: attn._flash_bwd_dq_kernel(
            q, k, v, do, lse, delta, **kw))
        dkv = _launch_profile(lambda: attn._flash_bwd_dkv_kernel(
            q, k, v, do, lse, delta, **kw))
        return {"flash_fwd": {**flash, **fwd},
                "flash_bwd_dq": {**dq, **bwd},
                "flash_bwd_dkv": {**dkv, **bwd}}

    live = _live_pairs(bh, s, s, causal)
    stats = bh * s * 4   # one f32 per row: lse or delta
    flops = {"flash_fwd": 4 * live * d, "flash_bwd_dq": 6 * live * d,
             "flash_bwd_dkv": 8 * live * d}
    nbytes = {"flash_fwd": 4 * n * 2 + stats,
              "flash_bwd_dq": 5 * n * 2 + 2 * stats,
              "flash_bwd_dkv": 6 * n * 2 + 2 * stats}
    bounds = {name: _bound(nbytes[name], flops[name]) for name in KERNELS}
    design = {"flash_fwd": attn.fwd_design(torch.bfloat16),
              "flash_bwd_dq": attn.bwd_design(torch.bfloat16),
              "flash_bwd_dkv": attn.bwd_design(torch.bfloat16)}
    bwd_vs_sdpa = (ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]) / sdpa_bwd_ms
    extra = {name: {"bwd_ms_vs_sdpa_bwd": bwd_vs_sdpa,
                    "same_bits_twice": same}
             for name, same in same_bits.items()}
    extra["flash_fwd"] = sdpa_error
    library = {"flash_fwd": (sdpa_fwd_ms, "torch SDPA forward"),
               "flash_bwd_dq": (sdpa_bwd_ms, "torch SDPA backward (dq, dk "
                                "and dv together)"),
               "flash_bwd_dkv": (sdpa_bwd_ms, "torch SDPA backward (dq, dk "
                                 "and dv together)")}
    shape = {"bh": bh, "s": s, "d": d, "causal": causal, "dtype": "bfloat16"}
    entries = [_entry(name, launches[name], errs[name],
                      ms[name], plain_ms[name], bounds[name],
                      library[name][0], flops[name], design[name],
                      path=path, tolerance=_tol_fields(torch.bfloat16),
                      err_share_of_limit=shares[name],
                      library=library[name][1], shape=shape,
                      **extra.get(name, {}))
               for name in KERNELS]
    share = None
    if n_layer is not None:  # a path with a step (the ring's blocks have none)
        attn_ms = (sum(ms.values()) + delta_ms) * n_layer
        share = {"path": path, "attention_ms_per_step": attn_ms,
                 "step_ms": step_ms,
                 "share": None if step_ms is None else attn_ms / step_ms,
                 "delta_ms": delta_ms, "bwd_ms_vs_sdpa_bwd": bwd_vs_sdpa,
                 "note": f"estimate: kernel ms at this shape x {n_layer} "
                         "launches / step ms, not a trace"}
    bad = [name for name, hs in held.items() if not all(h[0] for h in hs)]
    if bad:
        raise AssertionError(f"at the {path} shape {bad} disagree with "
                             f"their plain versions: {errs}, {shares} of "
                             "their limits")
    if not all(same_bits.values()):
        raise AssertionError(f"a second launch gave other bits: {same_bits}")
    return entries, share, profile


def phase_kernels(serve_launches, train_launches, step_ms, llama_serve,
                  llama_train, vit_train, moe_train, ring):
    """Every kernel at the shapes of every path: GPT-2's serving and
    training shapes, Llama-2-7B's prefill and decode shapes (the whole
    cache of 544 rows with the live length the path gives: 512 in the
    prefill, 543 in the last decode step) and its training shape,
    ViT-B/16's training shape (non-causal, S 197) and the MoE LM's (GPT-2's
    training shape, with the MoE path's launches and step); the ring's
    blocks (B*H 192, a chunk of 256: the diagonal causal, the rest whole,
    phase 26's launches by block kind) and the pipelined step's microbatch
    (B*H 48, S 1024, causal), whose launches and step phase 27 gives later
    (``_parallel_rows``). Returns (entries, the attention shares still
    waiting for their step)."""
    from ray_tpu_torch.tools import train_runs

    cache = LLAMA_SERVE["prompt"] + LLAMA_SERVE["new_tokens"]
    entries, profiles, shares = [], [], []
    for launches, path, bh, sq, sk, d, seed, k_len in (
            (serve_launches["flash_fwd"], "serve", 12, 512, 512, 64, 3,
             None),
            (llama_serve["prefill_launches"], "llama_prefill", 128,
             LLAMA_SERVE["prompt"], cache, 128, 6, LLAMA_SERVE["prompt"]),
            (llama_serve["decode_launches"], "llama_decode", 128, 1, cache,
             128, 7, cache - 1)):
        entry, profile = _fwd_shape_entry(launches, path, bh, sq, sk, d, seed,
                                          k_len)
        entries.append(entry)
        profiles.append(lambda e=entry, p=profile: e.update(p()))
    for launches, ms, path, b, h, s, d, n_layer, seed, causal in (
            (train_launches, step_ms, "train", 16, 12, 1024, 64, 12, 5,
             True),
            (llama_train[0], llama_train[1], "llama_train",
             LLAMA_TRAIN["batch"], 32, LLAMA_TRAIN["seq"], 128,
             LLAMA_TRAIN["layers"], 8, True),
            (vit_train[0], vit_train[1], "vit_train", VIT["batch"], 12, 197,
             64, 12, 9, False),
            (moe_train[0], moe_train[1], "moe_train", MOE["batch"], 12,
             MOE["seq"], 64, 12, 10, True),
            (dict.fromkeys(KERNELS), None, "pp_train",
             train_runs.BATCH // PARALLEL["microbatches"], 12,
             train_runs.SEQ, 64, 12 * PARALLEL["microbatches"], 11, True),
            (dict.fromkeys(KERNELS), None, "gang_train", GANG["rows"], 12,
             train_runs.SEQ, 64, None, 14, True),
            (ring["diag"], None, "ring_diag_block", RING["b"],
             RING["h"], RING["s"] // RING["n"], RING["d"], None, 12, True),
            (ring["full"], None, "ring_full_block", RING["b"],
             RING["h"], RING["s"] // RING["n"], RING["d"], None, 13,
             False)):
        group, share, profile = _train_shape_entries(
            launches, ms, path, b, h, s, d, n_layer, seed, causal)
        entries += group
        if share is not None:
            shares.append(share)

        def update(group=group, profile=profile):
            fields = profile()
            for e in group:
                e.update(fields[e["name"]])
        profiles.append(update)
    # the profiler runs last: once it has run, every launch costs the host
    # more, which would weigh on the CUDA-event times of many-launch calls
    # such as SDPA's forward + backward
    for update in profiles:
        update()
    for share in shares:
        if share["step_ms"] is not None:
            emit("attention_share", **share)
    return entries, [share for share in shares if share["step_ms"] is None]


def _gang_rows(entries, gang_launches):
    """Phase 36's launches into the gang's rows (B*H 96: a rank's 8 rows x
    12 heads), summed over both fits' workers, each worker's beside."""
    for entry in entries:
        if entry["path"] == "gang_train":
            per_worker = {fit: [w[entry["name"]] for w in workers]
                          for fit, workers in gang_launches.items()}
            entry["launches"] = sum(sum(v) for v in per_worker.values())
            entry["launches_per_worker"] = per_worker
            entry["note"] = ("phase 36's workers, 2 ranks sharing the card, "
                             "f32 and int8 fits; times are phase 15's at "
                             "this shape")


def _parallel_rows(entries, pending, parallel):
    """Phase 27's readings into the ``kernels`` line: the pipelined step's
    launches into its rows (and its step into its attention share), and
    the rows of the SP, TP, EP and Llama TP paths, which at world size one
    launch at the shapes of the GPT-2 training, MoE LM training and Llama
    serving rows and carry their times, with the launches phase 27 read
    around each path (Llama's prefill and decode apart)."""
    for entry in entries:
        if entry["path"] == "pp_train":
            entry["launches"] = parallel["pp"][entry["name"]]
    for share in pending:  # the pipelined step's
        share.update(step_ms=parallel["pp_step_ms"],
                     share=share["attention_ms_per_step"]
                     / parallel["pp_step_ms"])
        emit("attention_share", **share)
    source = {"sp_train": ("train", "sp"), "tp_train": ("train", "tp"),
              "ep_train": ("moe_train", "ep"),
              "llama_tp_prefill": ("llama_prefill", "llama_tp_prefill"),
              "llama_tp_decode": ("llama_decode", "llama_tp_decode")}
    rows = []
    for path, (origin, kind) in source.items():
        for entry in entries:
            if entry["path"] != origin:
                continue
            launches = parallel[kind][entry["name"]]
            rows.append(dict(entry, path=path, launches=launches,
                             note=f"phase 27's launches; times are phase "
                                  f"15's at the {origin} shape, which this "
                                  "path runs at world size one"))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import ray_tpu_torch.ops.attention  # noqa: F401  (fails outside the repo)

    seconds, t_main = {}, time.perf_counter()

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("device", phase_device)
    # A lane beside phases 28-31 and 24, which launch none of the three
    # kernels and are held to bars, not times (the rates they print are
    # taken beside the lane's GPT-2 runs): nvcc builds the kernels, then
    # phases 33 and 35 run, each on a cluster that is not this process's
    # (33's driven from CLI subprocesses, 35's from a process of its own),
    # to be held to their checks after phase 8. Everything after the
    # lane's end times the card alone.
    lane = concurrent.futures.ThreadPoolExecutor(2)
    build = lane.submit(timed, "build", phase_build)

    def beside_rllib():
        build.result()
        return (timed("cluster_cli_drive", cluster_cli_drive),
                timed("workflow_queue_drive", workflow_queue_drive))

    beside = lane.submit(beside_rllib)
    # the RLlib phases run before any profiler session of this process
    # (timing.py): their learners' updates are many small launches, and
    # phases 28-32 profile one update each only after phase 25
    profiles = timed("rllib_offline", phase_rllib_offline, smi)
    profiles["qmix_update"] = timed("rllib_qmix", phase_rllib_qmix, smi)
    profiles["r2d2_update"] = timed("rllib_r2d2", phase_rllib_r2d2, smi)
    profiles["dreamerv3_update"] = timed("rllib_dreamerv3",
                                         phase_rllib_dreamerv3, smi)
    timed("rllib_ppo", phase_rllib_ppo, smi)
    cluster_run, workflow_run = timed("lane_wait", beside.result)
    dt_entries, dt_kernel_profile, profiles["dt_update"] = timed(
        "rllib_dt", phase_rllib_dt, smi)
    timed("rllib_impala_group", phase_rllib_impala_group, smi)
    emit("rllib_update_profiles", **timed(
        "rllib_update_profiles",
        lambda: {name: profile() for name, profile in profiles.items()}),
         note="one update of each learner of phases 28-32 on the card: ms "
              "by CUDA events (median of 3), then its kernels' busy ms, "
              "launches and idle share from the profiler over one more")
    dt_kernel_profile()
    timed("kernel_vs_plain", phase_kernel_vs_plain)
    timed("bwd_kernel_vs_plain", phase_bwd_kernel_vs_plain)
    timed("serve_f32", phase_serve_f32)
    serve_launches, bf16_streams = timed("serve_bf16", phase_serve_bf16)
    timed("train_f32", phase_train_f32)
    train_launches, step_ms, bf16_losses = timed("train_bf16",
                                                 phase_train_bf16)
    from ray_tpu_torch.models.llama import LlamaConfig

    timed("llama_f32", phase_llama_f32)
    llama_serve = timed("llama_serve_7b", phase_llama_serve, "llama2_7b",
                        LlamaConfig.llama2_7b(), 20)
    timed("llama_serve_8b", phase_llama_serve, "llama3_8b",
          LlamaConfig.llama3_8b(), 30)
    llama_train = timed("llama_train", phase_llama_train)
    vit_train = timed("vit_train", phase_vit)
    resnet_train = timed("resnet_train", phase_resnet)
    moe_train = timed("moe_train", phase_moe_train)
    ring = timed("ring_attention", phase_ring_attention)
    kernels, pending = timed("kernels", phase_kernels, serve_launches,
                             train_launches, step_ms, llama_serve,
                             llama_train, vit_train, moe_train, ring)
    timed("llama_trace", phase_llama_trace, llama_serve)
    timed("moe_trace", phase_moe_trace, moe_train[1])
    def after_serve_run(port):
        return (timed("serve_multiplex_redeploy",
                      phase_serve_multiplex_redeploy, smi, port,
                      bf16_streams),
                timed("observe_dag_actor", phase_observe_dag_actor, smi,
                      bf16_streams))

    multiplex_launches, observed_launches = timed(
        "serve_run", phase_serve_run, smi, bf16_streams, after_serve_run)
    seconds["serve_run"] -= (seconds["serve_multiplex_redeploy"]
                             + seconds["observe_dag_actor"])
    nccl_ops = timed("train_fit", phase_train_fit, smi, bf16_losses, step_ms)
    tune_launches = timed("tune_asha_vit", phase_tune_asha, smi, vit_train[2],
                          vit_train[1])
    timed("data_resnet_fit", phase_data_resnet_fit, smi, *resnet_train)
    predict_launches = timed("batch_predict_vit", phase_batch_predict_vit,
                             smi)
    job_launches = timed("cluster_cli", phase_cluster_cli, smi,
                         cluster_run, bf16_losses, step_ms)
    replica_launches = timed("serve_autoscale", phase_serve_autoscale, smi,
                             bf16_streams)
    workflow_launches = timed("workflow_queue", phase_workflow_queue, smi,
                              workflow_run, bf16_losses, bf16_streams)
    gang_launches = timed("gang_data_plane", phase_gang_data_plane, smi,
                          bf16_losses, nccl_ops)
    # phase 27 forms and destroys an NCCL group in this process: after
    # every phase that times or traces a kernel
    parallel = timed("parallel_train", phase_parallel_train, bf16_losses,
                     step_ms, moe_train, llama_serve["tokens"])
    kernels += _parallel_rows(kernels, pending, parallel)
    _gang_rows(kernels, gang_launches)
    vit_entries = [e for e in kernels if e["path"] == "vit_train"]
    kernels += _tune_entries(vit_entries, tune_launches)
    kernels += _predict_entries(vit_entries, predict_launches)
    kernels += dt_entries
    train_step, serve_step, consumer = workflow_launches
    kernels += _worker_entries(kernels, [
        ("cluster_job_worker", job_launches,
         "the submitted job's worker counted on the launched node"),
        ("workflow_train_step", train_step,
         "the workflow's train step counted in its worker")], [
        ("serve_autoscaled_replicas", replica_launches,
         "summed over the autoscaled replicas"),
        ("workflow_serve_step", serve_step,
         "the workflow's serve step counted in its worker"),
        ("queue_consumer", consumer,
         "the queue's consumer actor counted"),
        ("serve_multiplex_replica", multiplex_launches,
         "the multiplexed replica's over its 5 answers, counted in it"),
        ("observed_dag_actor", observed_launches,
         "the DAG-driven actor's over its 4 answers, counted in it")])
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("seconds", **seconds, main_s=time.perf_counter() - t_main)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
