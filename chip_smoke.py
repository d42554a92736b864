#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. device   require a card; print its name and power limit
  2. build    compile every CUDA kernel of the path from ``src/repro_torch/
              kernels/csrc`` (one ``nvcc`` per source, all at once) and print
              the ``ptxas -v`` registers and spills and the tensor-core MMA
              opcodes of each library's SASS (bitgemm's must AND-popcount;
              ``flash_bf16_kernel<80>`` and ``<112>``, the exact-width plan,
              must not spill and must hold Q K^T's m64n64k16 and P V at
              their panels' N only: 64 + 16 and 64 + 32 + 16)
  3. kernels  each kernel against its plain torch version on the card, exact
              equality, over word widths, sizes, sentinels, hot indices and
              an out-of-range index that must raise at ``result()``:
              gather_total (P 0, 1, 2, 3, 5, 1000 and 1<<20, index views at
              odd and unequal offsets), gather_segment_totals (buckets 1 ..
              1<<14, G 1 / 3 / 32, all-sentinel tail segments; grouped waves
              of 1, 3, 34 and GROUP_CAP + 1 batches of mixed W, bucket and G,
              one launch for every GROUP_CAP; an out-of-range index in one
              batch of a wave raising at that batch's result() alone), total
              and items
  4. main     ``repro_torch.core.tcim_count`` on ``com-youtube`` at full size
              (the paper's Table II graph, generated from its config and
              seed), a cold and a warm count, each through ``build="auto"``,
              which must take the device build; held against the port's CPU
              path (the host build, whose stage split is logged beside the
              device's) and the exact oracle, both counted in host children
              started with the script (``_host_child``: "cpu-paths" on 3
              torch threads, "oracles" on 6 forked processes, while the
              kernels build), with the kernel's launch count
              equal to the device work list's windows (its pow2 bucket over
              the chunk); then ``ego-facebook`` and ``email-enron`` at
              slice_bits 32/64/128, device-built
  4b. build   (run after phase 6) the device build (``core.build``)
              bit-identical to the host build on the card (graph, SBF stores
              with their zero rows, work list with its ``-1`` padding):
              ego-facebook and email-enron at 32/64/128, com-youtube at 64
              (its host build the "cpu-paths" host child's); its stages synchronised one by
              one and its peak memory; ``device_build_async`` under
              ``torch.cuda.set_sync_debug_mode("error")``; the delta work list
              over random edge subsets against the host's; ego-facebook's
              device-built counts under ``pallas_unfused`` and
              ``pallas_items`` (the total and items kernels, a launch a
              window)
  5. timing   CUDA-event times of the kernel (through the executor's bound
              launcher and through gather_total_cuda) and its plain version
              at the host build's chunks of com-youtube, the bound, per-stage
              times and peak memory; the kernel's device time alone from a
              replayed CUDA graph of 50 launches (its sum held to the plain
              version's)
  6. serve    ``repro_torch.launch.tc_serve.TCServer`` on the card over 544
              small tenants (rmat at slice_bits 32 / 64 / 128, fused) and
              ego-facebook, email-enron and com-dblp at full size (solo),
              held against the exact oracle and a CPU server, the wave's 34
              fused batches in one launch of the segment kernel; a cached
              re-serve with no upload, in one launch; the solos in the modes
              gather_then_kernel and pallas_items; a tight budget; an
              injected failure, its batch out of the wave's one launch
  7. serve timing  the segment kernel over a serve wave's cached batches in
              one grouped launch, per call, through the executor's dispatch
              and as device time alone (a CUDA graph of whole-wave
              launches), beside the wave's bound, one launch a batch (no
              grouping) and the plain version; total and items vs plain over
              com-youtube's chunks (each also as device time alone, as in
              phase 5; distinct operands in turns, so that L2 does not hold
              them), fused serving vs the per-graph pool loop in graphs per
              second, serve stages and peak memory
  8. dense kernels  bitgemm (I, J in 1 .. 4039, W 1 / 3 / 8 / 9 / 127 / 255 /
              256 / 1147; random, zero and all-ones words; contiguous
              operands, copied to padded scratch when W is not a multiple of
              4, and row-padded views, read as they lie) and dense_mxu_tc (N
              1 .. 4039, densities 0.02 / 0.3 / 1.0 upper-triangular,
              lower-triangular, full and block-sparse {0,1} matrices) against
              their plain versions, exact, with dense_mxu_tc's k steps
              computed equal to its occupancy plan's; bitgemm must refuse a
              transposed, an int64 and a host operand
  9. dense    ``tcim_count(edges, backend="bitgemm" | "mxu")`` on
              ego-facebook and email-enron at full size against the exact
              oracle (and the port's CPU path on ego-facebook, counted in the
              "cpu-paths" host child), with launch
              counts (no bitgemm operand copied), stage split and peak memory
              (the mxu count's: A and its transpose); ``metrics.edge_support``
              (the items kernel) and ``baselines.matmul_tc`` on ego-facebook
 10. dense timing  bitgemm at an email-enron chunk beside its bound at the b1
              tensor-core rate (the int8 rate and the popcount unit logged
              beside it), its plain version and ``torch._int_mm`` on the bits
              as {0,1} int8 (checked equal to the kernel); dense_mxu_tc at
              ego-facebook's and email-enron's N (strictly upper-triangular,
              asserted; k steps == the plan's), beside its plain version, its
              bound (the triangular N(N-1)(N-2)/3, the dense 2 N^3 beside it)
              and ``torch._int_mm``
 11. flash cases  flash_attention against its plain version through both
              entries, bf16 (2e-2 elementwise, 1.2e-2 in relative norm per
              query row) and f32 (2e-5, 2e-5), hd 16 / 32 / 64 / 80 / 112 /
              128, causal or not: [BH, S, hd] with BH 1 / 3 / 72 and (Sq, Sk) from (1, 1)
              to (2048, 2048), ragged and offset (Sq < Sk); [B, S, H, hd] with
              B 1 / 3, (H, KH) (9, 3) / (4, 1), ragged and offset; reversed,
              permuted and keys-after-queries positions (rows with no visible
              key equal the mean of V); the kernel's count of scored KV tiles
              equal to the skip rule's in every case; an unsupported hd must
              raise
 12. LM serve  ``repro_torch.launch.serve.ServeSession`` with smollm-135m at
              full width (30 layers, random weights from seed 0): 8 prompts of
              4096 tokens and 32 generated, with 30 flash launches in prefill
              and none in decode; held against ``attention_impl="xla"`` on
              the same weights (prefill logits, every layer's KV cache, the
              logits at every position of two prompts and teacher-forced
              decode logits within 3e-2 in relative norm, layer 0's cache
              equal, both beside a float32 run of the same weights; a kernel
              planted to drop one KV tile must exceed the bound; prefill_s
              here, its flash share in phase 13); a float32
              run (equal tokens, 1e-3 elementwise); one prefill_32k sequence
              (32,768 tokens) against xla too
 13. flash timing  the kernel at the two prefill shapes (8 x 4096 and
              1 x 32,768, H 9, KH 3, hd 64, causal) through the [B, S, H, hd]
              entry, held to its plain version row by row (a planted dropped
              KV tile must fail that check) and its scored tiles to the skip
              rule, beside its bound, its plain version and
              ``scaled_dot_product_attention`` (enable_gqa) on the same
              operands

 14. stream   ``repro_torch.core.StreamingTCState`` / ``tcim_count_delta`` on
              the card (``build="auto"``: device delta work lists, the fused
              kernel through the stream's private executor, in-place store
              edits), benchmarks/bench_streaming.py's protocol at full size:
              roadnet-pa and email-enron at batch fractions 0.1 / 1 / 5 % of
              |E|, ego-facebook at 1 %; a held-out batch, one warm add/remove
              cycle, 3 measured rounds. Every batch's running count equal to
              ``verify()`` (a device-build recount), each fraction's end to
              the exact oracle and both recounts (warm device-build
              ``tcim_count``; host build + a fresh Executor, the bench's);
              launches equal to the delta work lists' windows; steady batches
              adopt nothing, upload no store bytes and build no library; no
              "auto" fallback. On email-enron at 1 % a before-count held in
              the stream's queue by ``torch.cuda._sleep`` while the stores
              are edited in place, and while they are re-adopted after
              growth (launcher rebuilt), both equal to the CPU path's. On
              roadnet-pa a remove-heavy run to a zero-record ratio above 0.5,
              ``compact()``, then ``spill()`` and a re-admitting batch. Logs
              ms a batch, the ``timings_s`` split, pairs, edges/s, launches,
              the store edit's device time, bytes uploaded, recount times,
              seed time and peak memory
 15. stream serve  ``TCServer`` with a WAL root: roadnet-pa (95 % of its
              edges) and email-enron (99 %) under a budget that holds one, so
              streams spill and re-admit; 12 deltas drained, 8 left pending,
              the server abandoned; ``TCServer.restore`` on the card and on
              the CPU replay and drain to the counts of a never-killed
              server (and the oracle), the restored servers' ``server_stats``
              equal; a root written by ``checkpoint()`` restored too
 16. sharded  ``repro_torch.distributed`` on meshes of logical shards on
              one card (4 x ``cuda:0``), over phase 4b's host build of
              com-youtube at full size: ``distributed_tc_count`` under
              ``replicated`` and ``sharded_cols`` on a 4-shard mesh and
              ``sharded_2d`` on 2 x 2 under ``packed`` and ``lockstep``,
              each equal to the oracle and the single-device count, with
              launches equal to the schedule's (steps x non-empty shard
              rows); ``count_plan_async`` under
              ``torch.cuda.set_sync_debug_mode("error")``; every step's
              per-shard partials of one sharded_2d count held to
              ``gather_total_reference`` on the same blocks and indices;
              ``resilient_tc_count`` on 2 x 2 losing a device at the middle
              step (the grid ``tc_remesh_plan((2, 2), 3)``'s, at most
              ``checkpoint_every`` steps replayed, exact), then
              ``resume_tc_count`` of its root onto a fresh mesh; end to end
              ``tcim_count(mesh=, placement="sharded_2d")`` on email-enron,
              a ``TCServer`` with ``mesh`` and ``resilience`` serving
              email-enron and com-dblp as resilient sharded solos, and a
              ``mesh=`` stream of email-enron in 1 % batches, each equal to
              ``verify()``. Logs wall ms a count per placement beside the
              replicated ``Executor``'s warm count, the planning /
              staging + dispatch / close split, steps, launches, index
              bytes, peak memory. Logical shards on one card measure the
              host's planning and staging and the launch count, not any
              scaling across cards
 17. contracts  ``repro_torch.runtime.contracts`` armed (``TCIM_CONTRACTS=1``
              for this phase only, so the earlier phases' times stay
              comparable): com-youtube's ``device_build_async`` (one staging
              call), the main count's dispatch (a warm re-dispatch under
              ``max_retrace(0)``) and ``tcim_count`` end to end (== the JAX
              package's 3,090,378), a fused wave of the serve phase's
              tenants and its cached re-serve at zero staging calls,
              ``TCServer`` over the serve fleet cold and cached, a steady
              email-enron stream round (every count and edit under
              ``max_retrace(0)``) and a 2 x 2 ``count_plan_async`` on four
              logical shards, each dispatch also under
              ``torch.cuda.set_sync_debug_mode("error")``; one planted
              violation a contract on CUDA tensors (a readback inside
              ``execute_indices_async``, an extra upload in the device
              build, a re-adopt on a steady stream signature), each raising
              ``ContractViolation``; host ms a call of
              ``execute_indices_async`` over the main count's resident
              windows and the warm main count's wall time, off and armed in
              alternating turns
 18. train    LM training on the card, smollm-135m at full width with
              ``attention_impl="xla"`` (as the reference trains; the flash
              kernel has no backward and launches no time here): ``loss_fn``
              and its autograd gradients in float32 at 2 x 128 (TF32 off) on
              the same parameters from one seed, held to the port's CPU path
              (loss within 1e-5 relative, every leaf within 1e-4 relative L2)
              under remat "none", "full" and "dots";
              ``make_train_step(microbatches=4)`` against 1 (the moments
              within 1e-5); ``TrainLoop`` in bf16 with remat "full", 8 x 2048
              tokens a step on ``SyntheticLMDataset``, 30 steps of lr 1e-3
              under ``{"warmup": 10, "total": 200}``: the loss must fall by
              0.3 (tests/test_system.py's bar), with the synchronised ms a
              step, tokens/s, the model-FLOPs share, peak memory and a
              ``torch.profiler`` step (device busy share, device time by
              op); in a child process under
              ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and deterministic
              algorithms (run in phase 18c's window), the three remat modes'
              gradients bit-equal and a resume at 4 layers (two injected
              failures, ``ckpt_every`` 10, ``run_with_auto_resume``): 2
              restarts, every logged loss and the final state equal to an
              uninterrupted run's
 18b. cost   the counted cost of the LM paths timed in phases 12 and 18
              (``analysis/hlo_cost.py::step_cost`` on meta tensors at their
              exact shapes: smollm-135m's train step, its flash prefill with
              30 launches reported by the kernel's wrapper, one decode step)
              and their roofline over the H100's constants; the train
              step's counted products within 1 % of ``_step_flops``'s, and
              no path's bound above its measured time; a gather_total and a
              flash launch on CUDA tensors each reported once to a counter
 18c. families train  the LM families' training on the card, every config
              at full width with ``attention_impl="xla"`` (flash has no
              backward; no kernel launches), the loops (2) first, then
              the holds (1) of the five smaller configs beside the
              deterministic children of phases 18, 20 and (3), every one a
              process of its own, and the vlm's hold last: (1) float32
              ``loss_and_grads``
              at 2 x 128 (TF32 off), remat "full", one parameter draw on the
              card copied to the host, the card against the port's CPU path
              (loss within 1e-5 relative, every metric, the MoE's router
              losses and dropped fraction included, and every gradient leaf
              within 1e-4 relative L2) for moonshot-v1-16b-a3b (MoE, 2
              layers, also under remat "dots"), zamba2-7b (7: a group of six
              mamba2 layers, the shared block and a trailing layer),
              mamba2-780m, hubert-xlarge, minicpm3-4b (MLA; 2 each) and the
              vlm (one group of 5, 6.39 B parameters: the host must hold
              about 52 GB for the CPU half, checked first; it runs alone,
              once both host children and the deterministic children have
              exited); (2) a bf16
              ``TrainLoop`` of five (moonshot 2 of 48 layers, zamba2 12 of
              81, mamba2 and hubert 24 of 48, minicpm3 12 of 62), 4 x 2,048
              tokens a step (MoE: routing groups of 1,024), remat "full", 30
              steps under ``{"warmup": 10, "total": 200}``: the first step's
              loss must exceed the mean of the last five by 0.3; ms a
              synchronised step, tokens/s, peak memory, the MoE's dropped
              fraction, a ``torch.profiler`` step (busy share) and the step's
              counted bound on meta tensors (phase 18b's format); (3) in a
              child process under deterministic algorithms, the MoE at one
              layer resumed from ``TrainLoop``'s checkpoints after a failure:
              every logged loss and dropped fraction and the final state
              bit-equal to an uninterrupted run's. The vlm does not train:
              its AdamW state alone (6.39 B x 12 B) passes the card
 19. families  the other LM families on the card. (a) Every arch's smoke
              config: ``forward_train`` logits, ``loss_fn`` and its metrics
              and every gradient leaf on the card within 1e-4 (relative, float32,
              TF32 off) of the port's CPU path on the same weights; decode
              against teacher forcing on the card within 2e-2
              (tests/test_models.py:70) under "xla" and, where the kernel
              takes the heads, "flash", every arch but the audio encoder.
              (b) Full width in bf16 through ``ServeSession``, weights drawn
              on the card from seed 0 (the vlm's cross-attention gates set
              to 0.5, so that the image tokens count), 4 x 512 prompt tokens
              and 16 generated: minicpm3-4b (MLA, 62 layers), mamba2-780m (48),
              zamba2-7b (81 + 13 shared-block applications), moonshot (MoE,
              12 of 48 layers) and llama-3.2-vision (10 of 100 layers, 1,601
              image tokens) under "xla", the last three also under "flash"
              (flash launches 13 (hd 112), 12 and 8 self + 2 cross, none at
              decode); hubert's ``forward_train`` on 4 x 512 frames under
              "xla" and "flash" (hd 80, not causal: 48 launches); the flash
              prefill (hubert: forward) logits within 3e-2 relative norm of
              xla's where bf16 keeps xla within 3e-2 of a float32 run of the
              same weights, never farther from float32 than xla plus 3e-2,
              and a planted dropped KV tile farther; the kernel at each
              path's attention shape against its plain version, timed with
              the wrapper and alone (a CUDA graph) beside its bound and
              SDPA (hd 112 and 80 are kernel rows of their own); parameters
              equal to ``count_params_analytical`` of the cut config, tokens
              in range, logits finite, ``prefill_s``, ms a decode step,
              tokens/s, peak memory, the MoE's dropped fraction at prefill
              and decode; "flash" on MLA (q/k 96, values 64) must raise
              ``ValueError`` and launch nothing. (c) Full width in float32
              at a cut depth (2 layers; the vlm one group of 5, the hybrid a
              group and a trailing layer, 7): decode against teacher forcing
              within 2e-2 (MLA, ssm, hybrid, vlm); the MoE's logits on the
              card within 1e-4 of the port's CPU path at 2 x 16 tokens, its
              dropped fraction equal
 20. sharded train  ``TrainLoop(mesh=)`` on meshes of logical shards of
              ``cuda:0`` (attention "xla"; no kernel launches): smollm-135m at
              full width on 2 x 2 (profile "dp": params replicated, one tensor
              a leaf; moments ZeRO-1 over 'data'; 8 x 2,048 tokens split four
              ways), phase 18's init, data and schedule, each of 6 losses
              within 3e-3 of phase 18's one-device losses; ms a step,
              tokens/s, peak memory, host ms of placing and gathering, a
              ``torch.profiler`` step (busy share, device time by op); its
              checkpoint of step 3 restored onto 4 x 1 and onto one device
              (every block bit-equal to the saved leaf's slice, steps 4-6
              within 3e-3 of the uninterrupted run); mamba2-780m at full
              width, 16 of 48 layers, bf16, 4 x 2,048, on 2 x 2 (profile "tp":
              ZeRO-3 blocks) against its one-device run (3 steps, losses
              within 3e-3), the bytes each position's blocks hold; float32
              gradients at 2 layers of both archs and of hubert-xlarge, the
              sharded step's reduced blocks within 1e-5 relative L2 a leaf of
              one device's (hubert's on the tensor-parallel train step, each
              position its 'model' blocks' share of the forward and
              backward; a shard's gradient reduced into its neighbour's
              model block refused); hubert-xlarge at 12 of 48 layers, bf16,
              4 x 512 frames, on that step against its one-device loop (6
              steps at a peak lr of 3e-4, losses within 3e-3);
              ``compressed_psum_mean`` over 8 logical 'pod' shards of
              [8, 64] and of eight single-row gradients of smollm's embedding,
              bit-equal to a NumPy emulation and within 0.02 of the exact mean;
              in a deterministic child (run in phase 18c's window), a 2 x 2
              loop at 4 layers resumed after a failure bit-equal to its
              uninterrupted run
 21. sharded serve  ``ServeSession(mesh=)`` on a 2 x 2 mesh of logical
              shards of ``cuda:0`` (the cache's batch over 'data', its
              sequence, or the SSM's heads, over 'model'; decode attention
              one float32 partial a sequence block and a logsumexp combine,
              the SSM step by head blocks). (a) smollm-135m at full width and
              depth, bf16, "flash", phase 12's weights and prompts, 8 x 4,096
              tokens and 32 generated, max_seq 4,128 (4,129 would not
              split): profile "dp", the prompt batch in 4 prefill shards, 30
              x 4 flash launches a prefill and none in decode; every k/v
              leaf's sequence on 'model'; teacher-forced on phase 12's
              tokens, the prefill and every decode step's logits within 3e-2
              relative norm of phase 12's (3 x the first run's 0.012342 is
              looser); a combine planted to drop the last block must exceed
              it; prefill_s, ms a step, tokens/s, peak memory, a profiled
              prefill and decode step. (b) minicpm3-4b (MLA) pinned to the
              "dp" profile, where it serves on the gathered path (each data
              shard's prefill, the latent cache's sequence blocks combined
              at decode), at full width and all 62 layers in bf16, phase
              19's 4 x 512 prompts and 16 steps, its q_norm scaled as 21d's
              (``_sharp_mla``), teacher-forced on its one-device session's
              tokens beside a float32 run of the same weights: within its
              bound of one device (``SERVE_SHARD_BF16_TOL``, 1.5 x
              ``tools/tp_drift.py``'s reading of the path on 2 x 2), and
              never farther from float32 than one device plus 3e-2; a
              prefill whose last data shard's cache is lost must fail the
              same rule. (c) float32 at
              full width, 2 layers (the VLM 5, zamba2 7), minicpm3-4b (MLA,
              pinned "dp" as in (b): the gathered path), moonshot (2 x 1,024
              tokens), the VLM, mamba2 and zamba2 (on their tensor-parallel
              path: the VLM's 5 layers launch flash 20 times) against the
              port's CPU
              session on the same weights: the prefill logits within 1e-4;
              a decode step (which reads the bf16 attention caches) within
              1e-4 of the card's one-device session's distance from the CPU
 21d. tensor-parallel serve  the dense, MLA, MoE, VLM, SSM and hybrid decoders on the 2 x 2
              mesh of logical shards tensor-parallel (``distributed/
              tensor_parallel.py``): each position gathers over 'data' only,
              into its 'model' block of every leaf whose spec has 'model',
              and computes its query heads (flash on H/m of them; MLA's
              head-aligned columns of wuq/wuk/wuv and rows of wo, its
              heads attending by "xla" over the latents the home sends),
              its columns of wq/wk/wv and wi_gate/wi_up, its rows of both wo
              (the partials reduced in float32), its E/m experts (routed
              once on the home; its share of the MoE's output reduced in
              float32), its columns of the VLM's image projection (once a
              prefill), its SSM heads and channels of B and C (the gated
              norm's statistic summed on the home) and its vocab block of
              the embedding and the logits; decode keeps the cache's
              flash-decoding layout, and reads and writes each shard's own
              blocks of the SSM states. deepseek-67b at full width, 8 of 95
              layers, bf16, phase 19's 4 x 512 prompts and 16 steps,
              teacher-forced on its one-device session's tokens within
              4.5e-2 (1.5 x the 0.030 at which any two bf16 runs whose
              roundings part land there, ``SERVE_TP_BF16_TOL``) and no
              farther from a float32 run of the same weights than one
              device plus 3e-2; float32 at 2 layers within 1e-4 of the
              one-device float32 session at the prefill and at each decode
              step fed a copy of its cache (TF32 off); qwen1.5-110b at 2
              layers (QKV biases drawn non-zero) within 3e-2 by the same
              rule; moonshot-v1-16b-a3b at 12 of 48 layers and dbrx-132b at
              2 of 40, bf16, at phase 19's shape (8 query and 8 KV heads, 32
              experts a shard; 24 and 4 heads, 8 experts), each within a
              bound set from a ``tools/tp_drift.py`` reading; their float32
              runs at 2 and 1 layers, 2 x 1,024 tokens (one routing group a
              data shard, capacity factor 1.25: tokens dropped), within
              1e-4 of one device. Layer 0's MoE on one input gives one
              device's choices and drops exactly and its output within 1e-4
              (bf16: 2^-8); the float32 prefill's drops a layer differ from
              one device's by at most the choices routed to another expert,
              at most 0.1 % of them (near ties that the reductions' order
              rounds apart). llama-3.2-vision-90b (cross gates opened to
              0.5, 1,601 image tokens from the phase's seed, around a
              shared direction so that the cross layers count) at 10 of 100
              layers in bf16 (two groups of 4 self and 1 gated cross
              layer) within a bound set from a ``tools/tp_drift.py``
              reading, and one group (5 layers) in float32 within 1e-4 of
              one device, whose steps are computed before its parameters
              are freed. mamba2-780m at all 48 layers in bf16 and 2 in
              float32, zamba2-7b at 15 of 81 (two groups of 6 mamba layers
              and the shared block, 3 trailing; flash on 16 query and 16 KV
              heads of hd 112 a shard) in bf16 and 7 in float32, their conv
              taps passing their input so that the state counts, each bf16
              run within a bound set from a ``tools/tp_drift.py`` reading.
              minicpm3-4b (MLA, 40 heads: 20 a shard) at all 62 layers in
              bf16 within a bound set from a ``tools/tp_drift.py`` reading
              and 2 in float32 within 1e-4 of one device, under "xla" (no
              flash launch; at decode each latent cache block's partial
              runs on the shard holding it). hubert-xlarge (the audio
              encoder, 16 heads: 8 a shard, hd 80, not causal) at all 48
              layers in bf16 within a bound of 1.5 x a card reading and 2 in
              float32 within 1e-4, under "flash": ``ServeSession`` refuses
              the encoder, so its prefill step on the mesh against one
              device's and ``forward_tp``'s full-frame logits against
              ``forward_train``, on 4 x 512 frames around a shared
              direction. Each run: the bytes each
              position gathered on this path and on the gathered path
              (under 0.55 of it), the flash launches (layers x data shards x
              model shards, each on H/m query heads, the VLM's cross layers
              non-causal at its 1,601 image keys; none at decode), the
              kernel held to its plain version at each of those shapes, the
              prefill and decode times beside the one-device session's (a
              first and a second run), peak memory, and planted faults the
              run's own rule must refuse: a reduction that drops the last
              shard's partial, (MoE) a shard that runs its neighbour's
              expert block, (VLM) a shard that takes its neighbour's
              KV heads of the image K/V in the cross layers only, (MLA) a
              shard that receives its neighbour's heads of the combined
              latent at decode, (SSM,
              hybrid) a shard that reads its neighbour's head block of the
              SSM state at decode, and (audio) a shard that attends to its
              neighbour's K/V heads

 22. livejournal  com-livejournal, the paper's largest graph, at full size
              (|V| 3,997,962, |E| 34,681,189, rmat from its config's seed).
              The "oracles" host child (no card visible to it) works on it
              in the background (nice 19) from phase 4 until before
              phase 18c's vlm hold, in two processes: one generates it
              and runs the host build's orient and SBF at 64 and 128 bits,
              the other counts the exact triangles of the graph scaled by
              0.5 (``triangles_intersection`` over 6 forked processes). No
              host child runs from that hold on, so phases 19-21 have the
              host to themselves. On the card:
              ``tcim_count(build="device")`` at full size raises the device
              build's documented ``ValueError`` at 64 and 128 bits (timed),
              after its orient and both SBF sides ran, whose valid slices and
              candidate totals (``DeviceBuildFuture.sizes()``) must equal the
              host build's and exceed 2**30; the x0.5 graph (921,636,266
              candidates at 64 bits, the largest bucket the device build
              takes: 2**30 lanes) through ``build="auto"``, which must take
              the device build, cold and warm, equal to the exact count, with
              its launches of gather_total equal to its windows, the stage
              split, pairs and peak memory, and the schedule step's own peak.
              The full-size count through the host build is
              ``tools/livejournal_count.py``'s (about half an hour of the
              host's ``build_worklist``)

Each path's kernel launch counts are set to 0 just before the path runs and
read just after it.

The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``. Imports ``torch``, ``numpy`` and the port
only: no JAX, nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The H100's HBM rate and dense bf16 tensor-core peak, as the roofline takes them.
from repro_torch.distributed.constants import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.distributed.constants import PEAK_FLOPS_BF16 as BF16_PEAK  # noqa: E402

MAIN_GRAPH = "com-youtube"
MAIN_SLICE_BITS = 64
JAX_PACKAGE_COUNT = 3_090_378  # the JAX package's count of the same graph, for the log
SMALL_GRAPHS = ("ego-facebook", "email-enron")
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor-core rate (float32 table entry)
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
POPC_PER_CLOCK_PER_SM = 16  # __popc issue rate, compute capability 9.0 (CUDA C++ Programming Guide)
# The b1 MMA's k step is 256 one-bit products in the 32 bytes a row that
# carry 32 int8 products at the int8 rate, so its rate in bit products is 8
# times int8's; tools/kernel_levers.py's probe measures 7.98 x on an H100.
B1_TENSOR_OPS_PER_S = 8 * INT8_TENSOR_OPS_PER_S
KERNEL_SOURCES = ("tc_gather_popcount", "slice_and_popcount", "tc_bitgemm", "tc_dense_mxu",
                  "flash_attention")
MIX_N = (64, 96, 128, 192, 256, 384, 512, 768)  # benchmarks/bench_serve.py's mix
EDGE_FACTOR = 6
NUM_TENANTS = 512  # at slice_bits 64
NUM_TENANTS_SIDE = 16  # at slice_bits 32 and at 128 each
SOLO_GRAPHS = ("ego-facebook", "email-enron", "com-dblp")
SEGMENT_BUCKETS = (1, 2, 16, 32, 64, 1024, 1 << 14)
GATHER_PAIRS = (0, 1, 2, 3, 5, 1000, 1 << 20)
GATHER_OFFSETS = ((0, 0), (1, 1), (3, 3), (1, 2), (0, 3))  # index views' (row, col) element offsets
GROUP_WAVES = (1, 3, 34)  # batches in a grouped segment wave, and GROUP_CAP + 1
DENSE_GRAPHS = ("ego-facebook", "email-enron")
DENSE_BACKENDS = ("bitgemm", "mxu")
BITGEMM_SIZES = (1, 31, 64, 129, 4039)
BITGEMM_WORDS = (1, 3, 8, 9, 127, 255, 256, 1147)
MXU_SIZES = (1, 33, 255, 256, 257, 4039)
MXU_DENSITIES = (0.02, 0.3, 1.0)
BITGEMM_CHUNK_ROWS = 2048  # tcim's bitgemm backend
NO_POPCOUNT_OP = "torch has no popcount op"
GRAPH_LAUNCHES = 50  # kernel launches in one CUDA graph: device time without the wrapper's
WAVE_GRAPH_LAUNCHES = 20  # whole-wave segment launches in one CUDA graph
FLASH_BH = (1, 3, 72)
FLASH_SHAPES = ((1, 1), (64, 64), (100, 100), (128, 128), (256, 128), (64, 256), (517, 1030),
                (2048, 2048))
FLASH_GQA_B = (1, 3)
FLASH_GQA_HEADS = ((9, 3), (4, 1))  # (H, KH)
FLASH_GQA_SHAPES = ((1, 1), (128, 128), (100, 300), (517, 1030))  # ragged, offset queries
FLASH_POSITIONS = ("reversed", "permuted", "keys after queries")
# The bf16 flash kernel's MMAs at the exact-width plan: Q K^T against a
# stage of 64 keys (m64n64k16) and P V a panel at its N (hd 80: 64 + 16
# columns, hd 112: 64 + 32 + 16).
FLASH_EXACT_MMA = {80: ("64x16x16", "64x64x16"), 112: ("64x16x16", "64x32x16", "64x64x16")}
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # tests/test_flash_and_cost.py's own
# Largest per-row ||got - want|| / ||want|| over query rows, ``want`` being
# the plain version's output before its last rounding. Outputs shrink as
# rows see more keys (about 0.01 at S 32,768), so an elementwise 2e-2 cannot
# see a wrong late row. The kernel's bf16 output rounding alone is up to
# 2^-8 of each element (3.9e-3 of a row); its weights are rounded at another
# scale than the plain version's. Read on an H100: at most 8.1e-3 (hd 16),
# 4.8e-3 at the prefill shapes; one KV tile dropped: at least 1.4e-2.
FLASH_ROW_TOL = {"bfloat16": 1.2e-2, "float32": 2e-5}
LM_ARCH = "smollm-135m"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 4096, 32
LM_LONG = 32768  # one prefill_32k sequence (configs/shapes.py)
LM_TOL = 3e-2  # the reference's flash-vs-xla bound (tests/test_flash_and_cost.py), here in relative norm
# The stream phases: benchmarks/bench_streaming.py's batch fractions and
# rounds at full size; roadnet-pa (no hubs, so a raw-id stream is cheap to
# seed), email-enron (the bench's gated fixture) and ego-facebook at 1 %.
STREAM_GRAPHS = (("roadnet-pa", (0.001, 0.01, 0.05)), ("email-enron", (0.001, 0.01, 0.05)),
                 ("ego-facebook", (0.01,)))
STREAM_SLICE_BITS = 64
STREAM_ROUNDS = 3  # measured add/remove cycles per fraction, after one warm cycle
STREAM_CHECK_FRACTION = 0.01  # email-enron's: the before-count checks stand in for its warm cycle
STREAM_COMPACT_GRAPH = "roadnet-pa"
STREAM_STALL_CYCLES = 1_000_000_000  # torch.cuda._sleep ahead of a checked before-count (~0.5 s)
SERVE_STREAMS = (("roadnet-pa", 0.95), ("email-enron", 0.99))  # (graph, share of edges seeded)
SERVE_DELTAS = 20  # the held-out edges in 20 deltas, alternating between the streams
SERVE_DRAINED = 12  # drained before the kill; the other 8 stay pending
SHARD_DEVICE = "cuda:0"  # every logical shard of phase 16's meshes
SHARD_CHECKPOINT_EVERY = 4
SHARD_E2E_GRAPH = "email-enron"
SHARD_SERVE_GRAPHS = ("email-enron", "com-dblp")
SHARD_STREAM_FRACTION = 0.01
CONTRACT_CALLS = 20  # execute_indices_async calls a timed turn (16 launches each)
CONTRACT_TURNS = 4  # turns of off, armed, armed, off
CONTRACT_COUNTS = 3  # warm main counts a mode, in the same turns
CONTRACT_STREAM = "email-enron"
CONTRACT_TENANTS = 16  # small tenants a fused batch of the contracts phase's wave
# The training phase (smollm-135m at full width, attention_impl "xla" as the
# reference trains): card-vs-CPU gradients in float32 at 2 x 128 under each
# remat mode, microbatching at 8 x 128, a bf16 run of 8 x 2048 with
# remat "full", and a deterministic resume at a cut depth in a child process.
TRAIN_ARCH = "smollm-135m"
TRAIN_REMATS = ("none", "full", "dots")
TRAIN_GRAD_SHAPE = (2, 128)
TRAIN_GRAD_TOL = 1e-4  # relative L2 a gradient leaf, card vs CPU, float32
TRAIN_LOSS_TOL = 1e-5  # relative, card vs CPU, float32
TRAIN_MICRO_SHAPE, TRAIN_MICROBATCHES, TRAIN_MICRO_TOL = (8, 128), 4, 1e-5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARM = 8, 2048, 30, 3  # cut from 40 for the time limit
TRAIN_SCHEDULE = {"warmup": 10, "total": 200}
TRAIN_MIN_DROP = 0.3  # tests/test_system.py's bar for the loss from step 1 to the last logged
COST_MATMUL_TOL = 0.01  # phase 18b: counted products against _step_flops's, relative
RESUME_LAYERS, RESUME_SHAPE, RESUME_STEPS = 4, (4, 256), 30
RESUME_FAIL_AT, RESUME_EVERY = (13, 24), 10
RESUME_FLAG = "--train-resume-child"  # the child process's mode (CUBLAS_WORKSPACE_CONFIG set)
# The families phase: every arch's smoke config on the card, then five
# decoders and the audio encoder at full width (bf16, cut in depth where the
# weights would pass about 21 GB) and four decoders plus the MoE at a cut
# depth in float32.
FAMILY_CARD_TOL = 1e-4  # card vs the port's CPU path, float32, relative norm / L2 a leaf
FAMILY_TF_TOL = 2e-2  # decode vs teacher forcing, tests/test_models.py:70
FAMILY_SERVE = (("minicpm3-4b", None, ("xla",)), ("mamba2-780m", None, ("xla",)),
                ("zamba2-7b", None, ("xla", "flash")), ("moonshot-v1-16b-a3b", 12, ("xla", "flash")),
                ("llama-3.2-vision-90b", 10, ("xla", "flash")))  # (arch, depth cut, impls)
# Flash launches a prefill (a forward): a layer each, the vlm's self + cross,
# zamba2's 13 shared-block applications, hubert's 48 encoder layers.
FAMILY_FLASH_LAYERS = {"moonshot-v1-16b-a3b": 12, "llama-3.2-vision-90b": 8 + 2,
                       "zamba2-7b": 13, "hubert-xlarge": 48}
FAMILY_AUDIO = "hubert-xlarge"
# The head widths whose only path is a family's: their kernel rows in the
# kernels line, timed at that path's shape (B 4, S 512).
FAMILY_FLASH_ROWS = {"zamba2-7b": "flash_attention[hd=112]", FAMILY_AUDIO: "flash_attention[hd=80]"}
# (ms a launch, ms alone on the device) of those rows before the exact-width
# plan and the lean launch path (hd 128's padded plan; strides from meta
# tensors), read on an NVIDIA H100 80GB HBM3 at 700 W: logged beside this
# run's readings.
FAMILY_FLASH_BEFORE = {"zamba2-7b": (0.149869, 0.065949), FAMILY_AUDIO: (0.088070, 0.035775)}
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 4, 512, 16  # B.S 2,048: two MoE groups of 1,024
FAMILY_F32_DEPTH = {"llama-3.2-vision-90b": 5, "zamba2-7b": 7}  # one group (+1 trailing); else 2
FAMILY_TF_SHAPE = (2, 32, 8)  # batch, tokens, the last ones decoded
FAMILY_MOE_SHAPE = (2, 16)
FAMILY_GATE = 0.5  # the vlm's cross-attention gates (tanh 0.46), so that image tokens count
# The families' training phase (18c), every config at full width and
# attention "xla" (flash has no backward): float32 gradients, card vs the
# port's CPU path, at phase 19c's cut depths (FAMILY_F32_DEPTH, else 2); a
# bf16 TrainLoop of each config whose AdamW state fits one card, cut in
# depth where parameters and state at about 22 B a parameter would pass
# about 53 GB, and the others to a quarter of their depth (zamba2, minicpm3:
# half of that cut) so that the script ends well inside its time limit (the
# VLM's 21d runs took their time); an MoE resume at one layer in a deterministic
# child. The VLM trains nowhere: its AdamW state alone (6.39 B x 12 B)
# passes the card.
FAMILY_TRAIN_GRADS = ("moonshot-v1-16b-a3b", "zamba2-7b", "mamba2-780m", "hubert-xlarge",
                      "minicpm3-4b", "llama-3.2-vision-90b")
FAMILY_TRAIN_DOTS = "moonshot-v1-16b-a3b"  # tests/test_torch_families_model.py holds its "dots"
FAMILY_VLM = "llama-3.2-vision-90b"  # its float32 hold takes 52 GB of the host and of the card
FAMILY_TRAIN_LOOPS = (("moonshot-v1-16b-a3b", 2), ("zamba2-7b", 6), ("mamba2-780m", 12),
                      ("hubert-xlarge", 12), ("minicpm3-4b", 6))  # (arch, depth cut)
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ, FAMILY_TRAIN_STEPS, FAMILY_TRAIN_WARM = 4, 2048, 30, 3
# TRAIN_MIN_DROP holds the first step's loss against the mean of the last five:
# one step's loss is noisy where few tokens count (hubert's masked
# prediction scores about 8 % of 8,192 frames a step).
FAMILY_TRAIN_TAIL = 5
FAMILY_RESUME_ARCH = "moonshot-v1-16b-a3b"
FAMILY_RESUME_LAYERS, FAMILY_RESUME_SHAPE, FAMILY_RESUME_STEPS = 1, (4, 256), 20
FAMILY_RESUME_FAIL_AT, FAMILY_RESUME_EVERY = (13,), 10
FAMILY_RESUME_FLAG = "--family-resume-child"
# The sharded training phase: meshes of logical shards of one card. smollm
# replays phase 18's first steps on 2 x 2 ("dp": params replicated, moments
# ZeRO-1); mamba2 runs its ZeRO-3 blocks ("tp") against its one-device run.
SHARD_TRAIN_MESH = (2, 2)
SHARD_TRAIN_STEPS, SHARD_TRAIN_CKPT = 6, 3  # cut from 10 and 5 for the time limit
# Absolute, bf16, sharded vs one device, every step: 3 x the largest
# difference read on an NVIDIA H100 80GB HBM3 at 700 W when the phase ran
# 10 steps (1.011e-3, at step 7), inside tests/test_distributed.py:401's
# 5e-3 after 5 steps. Over the 6 steps it runs now, the same card read at
# most 7.906e-4.
SHARD_LOSS_TOL = 3e-3
SHARD_MAMBA = "mamba2-780m"
SHARD_MAMBA_BATCH, SHARD_MAMBA_SEQ, SHARD_MAMBA_STEPS = 4, 2048, 3
SHARD_MAMBA_LAYERS = 16  # of 48, cut for the time limit (phase 18c trains all 48 on one device)
SHARD_GRAD_LAYERS, SHARD_GRAD_SHAPE, SHARD_GRAD_TOL = 2, (4, 256), 1e-5  # float32, relative L2
# The audio encoder trains tensor-parallel on 2 x 2 ("tp": each position
# computes its 'model' blocks' share of the forward and backward): its
# float32 gradients at SHARD_GRAD_LAYERS against one device, and a bf16
# TrainLoop at 18c's cut (12 of 48 layers) on 4 x 512 frames against its
# one-device loop, at a peak lr of SHARD_AUDIO_LR. At the other loops' 1e-3
# the one-device loop itself diverges from step 5 on an NVIDIA H100 80GB
# HBM3 at 700 W (losses 6.640, 6.512, 6.055, 4.889, 7.145, 8.892: past ln
# 504 = 6.22), and every 2 x 2 path parts from it there by more than the
# steps before (tools/train_drift.py, PERF.md's PR 35 entry); at 3e-4 the
# loss falls every step (6.640 to 4.802) and the paths stay within
# SHARD_LOSS_TOL.
SHARD_AUDIO = "hubert-xlarge"
SHARD_AUDIO_LAYERS, SHARD_AUDIO_SHAPE, SHARD_AUDIO_LR = 12, (4, 512), 3e-4
SHARD_PODS, SHARD_COMP_TOL = 8, 0.02  # compressed_psum_mean; tests/test_distributed.py:374's bound
SHARD_COMP_SHAPE = (8, 128)  # eight single-row gradients of the full-width embedding
SHARD_RESUME_FLAG = "--sharded-resume-child"
SHARD_RESUME_LAYERS, SHARD_RESUME_SHAPE, SHARD_RESUME_STEPS = 4, (4, 256), 12
SHARD_RESUME_FAIL_AT, SHARD_RESUME_EVERY = (7,), 5
# The sharded serve phase: ServeSession(mesh=) on 2 x 2 logical shards of
# cuda:0 (cache sequence over 'model', batch over 'data'). smollm-135m at
# full width and depth under "flash" on phase 12's weights: max_seq 4,128
# splits over 'model' (phase 12's 4,129 does not). The other decoders at
# phase 19's shapes and depth cuts; float32 at 2 layers against the CPU.
SERVE_SHARD_MESH = (2, 2)
SERVE_SHARD_MAX_SEQ = LM_PROMPT + LM_GEN
# Relative norm of each step's logits (bf16, teacher-forced on the
# one-device session's tokens), sharded against one device: 3 x the largest
# difference of the first card run (0.012342 at a decode step of smollm;
# the prefill's 0) is 0.037, so LM_TOL, never looser, holds.
SERVE_SHARD_TOL = LM_TOL
# (arch, depth cut) of 21b: the decoders served on the gathered path at full
# width in bf16, each on its profile there (SERVE_SHARD_PROFILE). minicpm3
# is pinned "dp" (``_pinned_profile``): on its own "tp" profile it serves
# tensor-parallel (21d), and the gathered MLA decode (``_mla_placed``)
# serves the "dp" profile.
SERVE_SHARD_FAMILIES = (("minicpm3-4b", None),)
SERVE_SHARD_PROFILE = {"minicpm3-4b": "dp"}  # 21b's and 21c's; tp_drift reads it too
# The attention of each decoder 21c runs (they serve tensor-parallel on 2 x
# 2, phase 21d holds their bf16 and float32 runs, but smollm's and
# minicpm3's pinned "dp"), and of 21b's, 21d's and tools/tp_drift.py's runs
# ("flash" for a config not here): MLA's values are narrower than its
# queries, which the flash kernel refuses.
SERVE_SHARD_IMPL = {LM_ARCH: "flash", "minicpm3-4b": "xla", "mamba2-780m": "xla",
                    "zamba2-7b": "flash", "moonshot-v1-16b-a3b": "flash",
                    "llama-3.2-vision-90b": "flash"}
SERVE_SHARD_F32_SHAPE = (4, 32, 4)  # batch, prompt, generated
SERVE_SHARD_F32_MOE_SHAPE = (2, 1024, 4)  # one routing group of 1,024 a data shard
# 21b's bf16 logits against the one-device session, a config (relative
# norm, max over the steps): 1.5 x the largest reading of its path on 2 x 2
# (tools/tp_drift.py, its weights as 21b's: q_norm scaled, _sharp_mla).
# Splitting the batch over the data shards changes the products' shapes, so
# their bf16 roundings part, and the parted roundings grow over the decode
# steps. A run is also held no farther from float32 than one device plus
# LM_TOL; 21c's float32 runs are the tight check.
SERVE_SHARD_BF16_TOL = {"minicpm3-4b": 1.5 * 0.092576}
# Phase 21d: the decoders served tensor-parallel on 2 x 2 logical
# shards of cuda:0 (each position gathers its 'model' blocks over 'data'
# and computes its heads, columns and vocab block). deepseek-67b at full
# width, cut to 8 of 95 layers (about 1.42 GB a layer and 3.36 GB of
# embedding and head in bf16: its placed blocks and the blocks a step
# gathers, both on the card, are 2 x 14.7 GB); float32 at 2 layers;
# qwen1.5-110b at 2 layers for the QKV biases (drawn at SERVE_TP_BIAS_STD:
# init makes them 0).
SERVE_TP_MESH = (2, 2)
SERVE_TP_RUNS = (("deepseek-67b", 2, "float32"), ("deepseek-67b", 8, "bfloat16"),
                 ("qwen1.5-110b", 2, "bfloat16"), ("moonshot-v1-16b-a3b", 2, "float32"),
                 ("moonshot-v1-16b-a3b", 12, "bfloat16"), ("dbrx-132b", 1, "float32"),
                 ("dbrx-132b", 2, "bfloat16"), ("llama-3.2-vision-90b", 5, "float32"),
                 ("llama-3.2-vision-90b", 10, "bfloat16"), ("mamba2-780m", 2, "float32"),
                 ("mamba2-780m", 48, "bfloat16"), ("zamba2-7b", 7, "float32"),
                 ("zamba2-7b", 15, "bfloat16"), ("minicpm3-4b", 2, "float32"),
                 ("minicpm3-4b", 62, "bfloat16"), ("hubert-xlarge", 2, "float32"),
                 ("hubert-xlarge", 48, "bfloat16"))  # (arch, depth cut, dtype)
# The VLM's runs: 10 of 100 layers in bf16 (21b's cut: two groups of 4 self
# and 1 cross layer, 10.67 B parameters, 21.3 GB; its float32 reference
# copy, 42.7 GB, sits beside it), one whole group (5 layers, 6.39 B, 25.6 GB
# a copy) in float32 at SERVE_SHARD_F32_SHAPE. The float32 run's one-device
# session computes its prefill, each decode step's starting cache and
# logits first and is freed before the mesh session places and gathers its
# copies (two copies on the card, not three). The cross gates are opened
# (_open_gates) and the image embeddings drawn from the phase's seed around
# a shared direction (_image_embeds).
# The MoE runs: moonshot-v1-16b-a3b at phase 19's cut (12 of 48 layers,
# 7.52 B parameters, 15.0 GB in bf16) and dbrx-132b at 2 of 40 (7.75 B,
# 15.5 GB; its bf16 and float32 copies together about 47 GB), their float32
# runs at SERVE_SHARD_F32_MOE_SHAPE (one routing group of 1,024 a data
# shard at the production capacity factor 1.25, so tokens are dropped), dbrx
# at 1 layer (18.0 GB a copy; the one-device, placed and gathered copies
# about 54 GB on the card).
# The SSM runs: mamba2-780m at all 48 layers in bf16 (about 1.6 GB), 2 in
# float32; zamba2-7b at 15 of 81 in bf16 (two groups of 6 mamba layers, each
# followed by the shared block, then 3 trailing: the full config's layout),
# 7 in float32 (one group and a trailing layer, FAMILY_F32_DEPTH). Their
# depthwise conv taps pass their input (_passing_conv), so that the scan's
# state counts in the logits.
# The MLA runs: minicpm3-4b at all 62 layers in bf16 (4.26 B parameters,
# 8.5 GB; 40 heads, 20 a shard on 2 x 2), 2 in float32, under "xla"
# (SERVE_SHARD_IMPL: no flash launch).
# The audio encoder's runs: hubert-xlarge at all 48 layers in bf16 (1.26 B
# parameters, 2.52 GB; 16 heads of 80, 8 a shard on 2 x 2, non-causal), 2 in
# float32, under "flash". ServeSession refuses the encoder (no decode step),
# so they call the prefill step on the mesh and on one device
# (make_prefill_step(cfg, mesh), make_prefill_step(cfg)) on AUDIO_TP_SHAPE
# frames (_audio_frames), and hold forward_tp's full-frame logits against
# one device's forward_train as well.
AUDIO_TP_SHAPE = (4, 512)  # batch, frames
SERVE_TP_SEED = 23  # the runs' prompts, image embeddings and frames, drawn run after run
SERVE_TP_BIAS_STD = 0.5
# A position's gathered bytes on the tensor-parallel path, the most of the
# gathered path's (every parameter whole): the leaves without a 'model' dim
# stay whole (MLA's latent projections, the SSM's B/C projections).
SERVE_TP_BYTES_SHARE = 0.55
# The MLA runs' query latent norms are scaled so that the scores' latent
# part spreads about this much (_sharp_mla): at the init's 0.14 each head's
# combined latent is nearly the prompt's mean, and a shard given its
# neighbour's heads of it lands inside the bf16 drift.
MLA_SCORE_STD = 1.0
# The MoE runs' routing against one device's. Layer 0's MoE on one input:
# the same choices and drops, the output within FAMILY_CARD_TOL (float32)
# or MOE_LAYER_BF16_TOL (bf16: the experts' shares summed in float32 and
# rounded once, one bf16 step, 2^-8, apart at most where the sums round
# apart). The float32 prefill: at most MOE_FLIP_TOL of the choices of the
# first layer whose routing parts from one device's moved to another
# expert (ties to the rounding of the reductions' order).
MOE_LAYER_BF16_TOL = 2.0 ** -8
MOE_FLIP_TOL = 1e-3
# bf16 logits against the one-device session: SERVE_SHARD_TOL, but for
# deepseek-67b at 8 layers. There two bf16 runs whose roundings part
# anywhere land about 0.030 apart whatever parts them (tools/tp_drift.py on
# the card: the gathered path on 2 x 2 0.030047 from one device, the
# tensor-parallel path on 2 x 1, which splits no product, 0.029977), and the
# tensor-parallel path on 2 x 2 read 0.032550 and 0.034763 in two card runs:
# the bound is 1.5 x that floor. A run is also held no farther from float32
# than one device plus LM_TOL; the float32 run at 1e-4 is the tight check
# of the path.
# The MoE runs' bounds are 1.5 x the largest reading of tools/tp_drift.py
# (same card) at their cuts, over the tensor-parallel path on 2 x 2, 1 x 2
# and 2 x 1 and the gathered path on 2 x 2: moonshot 0.050049 (1 x 2; the
# floor, 2 x 1, 0.049662), dbrx 0.337294 (2 x 1, which splits no product;
# the tensor-parallel path on 2 x 2 read 0.175984). dbrx's random router is
# near uniform over 16 experts, so a bf16 rounding moves top-4 choices and
# one device lands 0.326 from float32 itself; its float32 run is the check.
# The VLM's at 10 layers: 1.5 x its largest reading, 0.033598 (1 x 2; 2 x 2
# 0.033594, 2 x 1 0.031270, the gathered path 0.031404), with 21d's image
# embeddings (_image_embeds). mamba2's at 48 layers: 0.043560 (2 x 2 and
# 1 x 2, prefill 0.043379; 2 x 1 and the gathered path 0.031704, prefill
# 0.0: the split norm statistic and the float32 out reduce part the bf16
# roundings from one device's); zamba2's at 15: 0.028908 (2 x 2; 1 x 2
# 0.028542, 2 x 1 0.027917, the gathered path 0.028309), both with their
# conv taps passing their input (_passing_conv; one device 0.061821 and
# 0.042172 from float32). minicpm3's at 62 layers, its query latent norms
# scaled (_sharp_mla): 0.093363 (2 x 2; 1 x 2 0.093355, 2 x 1 0.091493, the
# gathered path 0.092576; prefill 0.066203 where 'model' splits wo, else 0.0);
# the sharper attention parts the bf16 roundings more (one device 0.197627
# from float32; at the init's weights the gathered path read 0.072696 and
# one device 0.058-0.077). hubert's at 48 layers (its last and full-frame
# logits, _audio_frames): 1.5 x tools/tp_drift.py's largest reading,
# 0.019530 (the full-frame logits on 2 x 2 and 1 x 2; the last 0.019453;
# on 2 x 1 and the gathered path pinned "dp" 0.0, their arithmetic one
# device's; one device 0.017432 / 0.018088 from float32).
SERVE_TP_BF16_TOL = {"deepseek-67b": 1.5 * SERVE_SHARD_TOL, "moonshot-v1-16b-a3b": 1.5 * 0.050049,
                     "dbrx-132b": 1.5 * 0.337294, "llama-3.2-vision-90b": 1.5 * 0.033598,
                     "mamba2-780m": 1.5 * 0.043560, "zamba2-7b": 1.5 * 0.028908,
                     "minicpm3-4b": 1.5 * 0.093363, "hubert-xlarge": 1.5 * 0.019530}
# A bf16 run lands no farther from float32 than one device plus LM_TOL; for
# dbrx plus its bound: two runs that far apart may differ by that much in
# their distance from float32 (the triangle inequality), and its readings
# of one device against float32 spread 0.149-0.394 with the prompts, the
# tensor-parallel path's 0.213-0.326 (tools/tp_drift.py and 21d, same card).
SERVE_TP_F32_MARGIN = {"dbrx-132b": SERVE_TP_BF16_TOL["dbrx-132b"]}
# The com-livejournal phase: the paper's largest graph at full size (|V|
# 3,997,962, |E| 34,681,189, rmat from its seed). Its host work runs in a
# child process in the background from the script's start and ends before
# phase 18c's vlm hold. The device build refuses it past 2**30
# candidates; the graph scaled by LJ_LIMIT_SCALE fills the largest bucket
# the device build takes (921,636,266 candidates at 64 bits, a bucket of
# 2**30 lanes). The full-size count through the host build is
# tools/livejournal_count.py's.
LJ_GRAPH = "com-livejournal"
LJ_SLICE_BITS = (64, 128)
LJ_LIMIT_SCALE = 0.5
LJ_ORACLE_WORKERS = 6  # with the full graph's process, 7 of the host's 8 cores when idle
HOST_CHILD_FLAG = "--host-child"  # _host_child: the host's work of phases 4, 4b, 9, 18c and 22
CPU_PATH_THREADS = 3  # torch threads of the "cpu-paths" child, beside the card's phases
HOST_SBF_FIELDS = ("slice_bits", "n", "n_slices", "row_ptr", "row_slice_idx", "row_slice_data",
                   "col_ptr", "col_slice_idx", "col_slice_data")
HOST_WORKLIST_FIELDS = ("pair_edge", "pair_row_pos", "pair_col_pos", "m_edges")  # + the SBF's n_slices
LJ_CHILD_TIMEOUT = 1200  # seconds phase 18c waits for the host children at most
MAIN_ORACLE_TIMEOUT = 600  # seconds phase 4 waits for com-youtube's exact count at most


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return 1e6 * float(out.splitlines()[0])


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s); card 0: {name}")
    log(f"[device] nvidia-smi: {nvidia_smi_line()}; max SM clock {sm_clock_hz() / 1e6:.0f} MHz; "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.compile_sources(KERNEL_SOURCES)
    log(f"[build] {len(libs)} kernel source(s) built in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        for line in _build.ptxas_report(name):
            log(f"[build] {name}: {line}")
        log(f"[build] {name}: SASS MMA opcodes {_build.sass_mma_opcodes(name)}")
    bitgemm_mma = [op for op in _build.sass_mma_opcodes("tc_bitgemm") if "POPC" in op]
    check(bool(bitgemm_mma), "tc_bitgemm's SASS holds no AND-popcount tensor-core MMA")
    kernels = _build.ptxas_kernels("flash_attention")
    sass = _build.sass_mma_by_kernel("flash_attention")
    for hd, shapes in FLASH_EXACT_MMA.items():
        names = [k for k in kernels if f"flash_bf16_kernelILi{hd}E" in k]
        check(len(names) == 1, f"flash_bf16_kernel<{hd}>: {len(names)} kernels in ptxas' report")
        ptx, ops = kernels[names[0]], sass.get(names[0], [])
        log(f"[build] flash_bf16_kernel<{hd}>: {ptx.get('registers')} registers, "
            f"{ptx.get('spill_stores')} bytes spill stores, {ptx.get('spill_loads')} bytes spill "
            f"loads; SASS MMA opcodes {ops}")
        check(ops == sorted(f"HGMMA.{s}.F32.BF16" for s in shapes),
              f"flash_bf16_kernel<{hd}>: SASS MMA opcodes {ops}, not Q K^T's m64n64 and P V at "
              f"the exact panels' N {shapes}")
        check(ptx.get("spill_stores") == 0 and ptx.get("spill_loads") == 0,
              f"flash_bf16_kernel<{hd}> spills: {ptx}")


def _words(rng, rows: int, w: int) -> torch.Tensor:
    a = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).cuda()


def _compare(row, col, ridx, cidx) -> tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.kernels.tc_gather_popcount import (
        gather_total_cuda,
        gather_total_reference,
    )

    got = gather_total_cuda(row, col, ridx, cidx, torch.zeros(2, dtype=torch.int32, device="cuda"))
    want = gather_total_reference(row, col, ridx, cidx)
    torch.cuda.synchronize()
    return got.cpu(), want.cpu()


def phase_kernel_cases() -> int:
    """gather_total: kernel == plain version on the card; returns max |err|."""
    from repro_torch.core.executor import CountFuture

    log("[kernels] tolerance: exact equality (integer counts, any order of adds)")
    rng = np.random.default_rng(0)
    max_err = 0
    num_rows, num_cols = 50_000, 30_011
    for w in (1, 2, 4):
        row, col = _words(rng, num_rows, w), _words(rng, num_cols, w)
        for p in GATHER_PAIRS:
            r = rng.integers(0, num_rows, size=p + 3).astype(np.int32)
            c = rng.integers(0, num_cols, size=p + 3).astype(np.int32)
            r[rng.random(p + 3) < 0.1] = -1  # sentinels on either side
            c[rng.random(p + 3) < 0.1] = -1
            hot = rng.random(p + 3) < 0.25  # repeated hot indices
            r[hot], c[hot] = 7, 11
            r_all, c_all = torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda()
            # Index views at offsets 0, odd and even-not-16-byte, the same on
            # both sides (the int4 path after a scalar head) or not (the
            # scalar path); the arrays hold 3 more pairs, never to be read.
            for ro, co in GATHER_OFFSETS:
                got, want = _compare(row, col, r_all[ro : ro + p], c_all[co : co + p])
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                check(torch.equal(got, want),
                      f"W={w} P={p} offsets {ro, co}: kernel {got.tolist()} != plain {want.tolist()}")
            log(f"[kernels] gather_total W={w} P={p}: {got.tolist()} == plain at index offsets "
                f"{list(GATHER_OFFSETS)}")
    # One out-of-range index per side: counted, never read, raised at result().
    row, col = _words(rng, num_rows, 2), _words(rng, num_cols, 2)
    for side in ("row", "col"):
        r = rng.integers(0, num_rows, size=1000).astype(np.int32)
        c = rng.integers(0, num_cols, size=1000).astype(np.int32)
        if side == "row":
            r[500] = num_rows + 5
        else:
            c[500] = num_cols
        got, want = _compare(row, col, torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda())
        check(torch.equal(got, want) and int(got[1]) == 1, f"out-of-range {side}: {got.tolist()} vs {want.tolist()}")
        try:
            CountFuture([got.cuda()]).result()
        except ValueError as e:
            log(f"[kernels] out-of-range {side} index raised at result(): {e}")
        else:
            raise RuntimeError(f"out-of-range {side} index did not raise at result()")
    return max_err


def _edges(cfg) -> np.ndarray:
    from repro_torch.graphs import GRAPH_GENERATORS

    gen = GRAPH_GENERATORS[cfg.generator]
    if cfg.generator == "grid_road":
        return gen(cfg.n, seed=cfg.seed)
    return gen(cfg.n, cfg.m, seed=cfg.seed)


def phase_main(oracles: tuple, cpu_paths: tuple) -> dict:
    """The main path on the card (``build="auto"``: the device build), a
    cold and a warm count, held against the CPU path (the host build, whose
    stage split is logged beside the device's) and the oracle, both counted
    by the host children (``_host_child``: the same graph, made from its
    config and seed, while the kernels build)."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import tcim_count
    from repro_torch.core.plan import clamp_chunk_pairs, pow2_ceil
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda

    cfg = GRAPHS[MAIN_GRAPH]
    t0 = time.perf_counter()
    edges = _edges(cfg)
    log(f"[main] {cfg.name}: generated |V|={cfg.n} |E|={len(edges)} in {time.perf_counter() - t0:.2f} s")

    chunk = clamp_chunk_pairs(1 << 20, MAIN_SLICE_BITS // 32)
    runs = {}
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gather_total_cuda.launches = 0
        t0 = time.perf_counter()
        res = tcim_count(edges, slice_bits=MAIN_SLICE_BITS)
        wall = time.perf_counter() - t0
        launches = gather_total_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        # The device work list is -1-padded to its pow2 bucket; the executor
        # runs it in windows of `chunk` pairs, one launch a window.
        windows = math.ceil(pow2_ceil(res.stats["num_pairs"]) / chunk)
        log(f"[main] card, {label} count: {res.triangles} triangles, build "
            f"{res.stats['build']!r}, {res.stats['num_pairs']} slice pairs, {windows} windows, "
            f"{launches} kernel launches, {wall:.6f} s wall; max_memory_allocated {peak} bytes")
        log(f"[main] card, {label} count, timings_s: {json.dumps(res.timings_s)}")
        check(res.stats["device"].startswith("cuda"), f"main path ran on {res.stats['device']}")
        check(res.stats["build"] == "device", f"build='auto' on the card took {res.stats['build']!r}")
        check(launches == windows, f"kernel launched {launches} times for {windows} windows")
        runs[label] = {"result": res, "wall": wall, "launches": launches, "peak": peak}

    t0 = time.perf_counter()
    cpu = _child_result(cpu_paths, "main.json", MAIN_ORACLE_TIMEOUT)
    check(cpu["m"] == len(edges), f"[main] the CPU path's graph has {cpu['m']} edges")
    log(f"[main] port CPU path (in the host child): {cpu['triangles']} "
        f"triangles, build {cpu['build']!r}, {cpu['wall']:.6f} s wall; waited "
        f"{time.perf_counter() - t0:.3f} s here")
    log(f"[main] host build split (the CPU path's timings_s; its orient, compress and schedule "
        f"are the host front end): {json.dumps(cpu['timings_s'])}")
    check(cpu["build"] == "host", f"the CPU path took build {cpu['build']!r}")
    g = build_graph(edges, reorder=True)
    t0 = time.perf_counter()
    host = _child_result(oracles, "main.json", MAIN_ORACLE_TIMEOUT)
    exact = host["exact"]
    check(host["m"] == len(edges), f"[main] the host child's graph has {host['m']} edges")
    log(f"[main] exact oracle (triangles_intersection over {LJ_ORACLE_WORKERS} processes in "
        f"the host child): {exact} in {host['oracle_s']:.2f} s there; waited "
        f"{time.perf_counter() - t0:.2f} s here")
    log(f"[main] JAX package's count of this graph, for reference: {JAX_PACKAGE_COUNT}")
    for label, run in runs.items():
        got = run["result"]
        check(got.triangles == cpu["triangles"] == exact,
              f"card ({label}) {got.triangles}, CPU {cpu['triangles']}, oracle {exact}")
        check(got.stats["num_pairs"] == cpu["num_pairs"] and got.stats["nvs"] == cpu["nvs"],
              f"card ({label}) stats {got.stats} != CPU path's {cpu}")

    for name in SMALL_GRAPHS:
        small = _edges(GRAPHS[name])
        want = triangles_intersection(build_graph(small, reorder=True))
        for bits in (32, 64, 128):
            res = tcim_count(small, slice_bits=bits)
            check(res.triangles == want and res.stats["build"] == "device",
                  f"{name} slice_bits={bits}: card {res.triangles} ({res.stats['build']}) != oracle {want}")
            log(f"[main] {name} slice_bits={bits}: {res.triangles} == oracle (device build)")
    cold = runs["cold"]
    return {"graph": g, "edges": edges, "launches": cold["launches"], "result": cold["result"],
            "peak": cold["peak"], "warm": runs["warm"], "host_timings": cpu["timings_s"],
            "exact": exact}


def _check_build_identical(db, g, sb, wl, label: str) -> None:
    """A device build == the host build of the same graph, array for array
    (dtypes too), with the stores' zero rows and the pairs' -1 padding."""
    from repro_torch.core.plan import pow2_ceil

    gh = db.graph.to_host()
    for f in ("edges", "indptr", "indices"):
        check(np.array_equal(getattr(gh, f), getattr(g, f)), f"{label}: graph {f} differs")
    dsb, dwl = db.to_host()
    for f in ("row_ptr", "row_slice_idx", "row_slice_data", "col_ptr", "col_slice_idx",
              "col_slice_data"):
        a, b = getattr(dsb, f), getattr(sb, f)
        check(a.dtype == b.dtype and np.array_equal(a, b), f"{label}: sbf {f} differs")
    for f in ("pair_edge", "pair_row_pos", "pair_col_pos"):
        check(np.array_equal(getattr(dwl, f), getattr(wl, f)), f"{label}: worklist {f} differs")
    p = wl.num_pairs
    for f in ("pair_edge", "pair_row_pos", "pair_col_pos"):
        pad = getattr(db.worklist, f)
        check(len(pad) == pow2_ceil(max(p, 1)) and bool((pad[p:] == -1).all()),
              f"{label}: {f} is not -1-padded to its pow2 bucket")
    for side, valid in (("row", db.sbf.row_valid), ("col", db.sbf.col_valid)):
        store = getattr(db.sbf, f"{side}_slice_data")
        check(store.shape[0] == pow2_ceil(max(valid, 1)) and not bool(store[valid:].any()),
              f"{label}: {side} store is not zero-padded to its pow2 rows")


def _device_intervals(events) -> list[tuple[float, float]]:
    """Merged [start, end) microsecond intervals of the profiled device
    activity (kernels and copies)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    merged: list[list[float]] = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def _profile_count(edges: np.ndarray) -> None:
    """One warm device-built count under ``torch.profiler``: the device's
    busy share of the count's wall, and its device time by torch op."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import tcim_count

    tcim_count(edges, slice_bits=MAIN_SLICE_BITS)  # warm: pool entry, lazy modules
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = tcim_count(edges, slice_bits=MAIN_SLICE_BITS)
        wall = time.perf_counter() - t0
    check(res.triangles == JAX_PACKAGE_COUNT, f"profiled count {res.triangles}")
    busy = sum(end - start for start, end in _device_intervals(prof.events()))
    if busy == 0:
        log("[device build] profiled count: the profiler recorded no device activity; the "
            "device's busy share is not measured")
        return
    # Each op's own kernels (its children's are theirs): a partition of the
    # device time by torch op.
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    log(f"[device build] profiled warm count (torch.profiler, CPU + CUDA): {wall:.6f} s wall "
        f"under the profiler, device busy {busy / 1e6:.6f} s = {100 * busy / (1e6 * wall):.2f} % "
        f"of it; timings_s {json.dumps(res.timings_s)}")
    for e in ops[:10]:
        log(f"[device build]   {e.key}: {e.self_device_time_total / 1e3:.3f} ms on the device, "
            f"{e.count} calls")


def phase_device_build(main: dict, cpu_paths: tuple) -> None:
    """The device build on the card: bit-identical to the host build, its
    synchronised stage split and peak, no host sync inside
    ``device_build_async``, the delta work list, and the unfused backends
    over a device build. Leaves com-youtube's host SBF and work list (the
    "cpu-paths" host child's build) in ``main`` for the timing phase."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import (
        build_sbf,
        build_worklist,
        build_worklist_pairs,
        device_build,
        device_build_async,
        device_build_sbf,
        device_build_worklist,
        device_delta_worklist,
        sbf_from_arrays,
        tcim_count,
        worklist_from_arrays,
    )
    from repro_torch.core.plan import clamp_chunk_pairs, pow2_ceil
    from repro_torch.graphs import build_graph, csr, device_orient, triangles_intersection

    cases = [(name, bits) for name in SMALL_GRAPHS for bits in (32, 64, 128)]
    for name, bits in cases + [(MAIN_GRAPH, MAIN_SLICE_BITS)]:
        if name == MAIN_GRAPH:  # its host build is the "cpu-paths" host child's
            edges, g = main["edges"], main["graph"]
            info = _child_result(cpu_paths, "host_build.json", MAIN_ORACLE_TIMEOUT)
            check(info["m"] == len(edges), f"[device build] the host child's graph: {info}")
            with np.load(cpu_paths[1] / "host_build.npz") as arrays:
                sb, wl = sbf_from_arrays(arrays), worklist_from_arrays(arrays)
            host_s = info["s"]
        else:
            edges = _edges(GRAPHS[name])
            g = build_graph(edges, reorder=True)
            t0 = time.perf_counter()
            sb = build_sbf(g, bits)
            wl = build_worklist(g, sb)
            host_s = time.perf_counter() - t0
        db = device_build(edges, slice_bits=bits)
        _check_build_identical(db, g, sb, wl, f"{name} slice_bits={bits}")
        log(f"[device build] {name} slice_bits={bits}: graph, SBF ({db.sbf.row_valid} + "
            f"{db.sbf.col_valid} records) and work list ({wl.num_pairs} pairs) identical to the "
            f"host build ({host_s:.3f} s of host compress + schedule"
            f"{' in the host child' if name == MAIN_GRAPH else ''})")
        if name == MAIN_GRAPH:
            main["sbf"], main["worklist"] = sb, wl
    del db

    # The stages one by one, each synchronised, and the build's peak memory.
    edges = main["edges"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dg = device_orient(edges)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dsb = device_build_sbf(dg, MAIN_SLICE_BITS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dwl = device_build_worklist(dg, dsb)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base
    padded = np.full((pow2_ceil(len(edges)), 2), main["graph"].n, dtype=np.int32)
    padded[: len(edges)] = edges
    t_hash = time.perf_counter()
    csr.content_key(padded, len(edges), main["graph"].n, True)
    t_hash = time.perf_counter() - t_hash
    check(dwl.num_pairs == main["worklist"].num_pairs, "granular stages' pair count")
    log(f"[device build] {MAIN_GRAPH}, stages synchronised one by one: orient {t1 - t0:.6f} s "
        f"(of it the host's blake2b content key over the {4 * padded[: len(edges)].size}-byte "
        f"int32 edge list, timed alone: {t_hash:.6f} s), compress {t2 - t1:.6f} s (with the [row_nvs, col_nvs] readback), "
        f"schedule {t3 - t2:.6f} s (with the candidate and pair readbacks), "
        f"{dwl.num_candidates} candidates in a bucket of {pow2_ceil(dwl.num_candidates)} lanes, "
        f"{dwl.num_pairs} pairs in {len(dwl.pair_row_pos)}; peak above the held memory "
        f"{peak} bytes (max_memory_allocated)")
    del dg, dsb, dwl

    # No host sync between the upload and result(): any raises here.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = device_build_async(edges, slice_bits=MAIN_SLICE_BITS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    db = fut.result()
    check(db.worklist.num_pairs == main["worklist"].num_pairs, "async build's pair count")
    log(f"[device build] device_build_async ran under torch.cuda.set_sync_debug_mode('error') "
        f"with no host sync; its result() has {db.worklist.num_pairs} pairs, as the host build")
    _profile_count(edges)

    # Delta work lists over random edge subsets, against the host's pairs.
    rng = np.random.default_rng(0)
    for name, frac in (("ego-facebook", 0.2), (MAIN_GRAPH, 0.1)):
        if name == MAIN_GRAPH:
            g, sb, dsb = main["graph"], main["sbf"], db.sbf
        else:
            g = build_graph(_edges(GRAPHS[name]), reorder=True)
            sb = build_sbf(g, MAIN_SLICE_BITS)
            dsb = device_build(_edges(GRAPHS[name]), slice_bits=MAIN_SLICE_BITS).sbf
        pick = np.sort(rng.choice(g.m, size=int(frac * g.m), replace=False))
        src, dst = g.edges[pick, 0], g.edges[pick, 1]
        want = build_worklist_pairs(src, dst, sb)
        for over, kind in ((sb, "host"), (dsb, "device")):
            dw = device_delta_worklist(src, dst, over).to_host()
            got = (dw.pair_edge, dw.pair_row_pos, dw.pair_col_pos)
            check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"{name}: delta work list over the {kind} SBF differs from the host's")
        log(f"[device build] {name}: delta work list of {len(src)} edges ({len(want[0])} pairs) "
            f"over the host and the device SBF == host build_worklist_pairs")
    del db

    # Kernels 3 and 4 over a device build (the unfused backends).
    edges = _edges(GRAPHS["ego-facebook"])
    want = triangles_intersection(build_graph(edges, reorder=True))
    wrappers = _wrappers()
    for backend, kernel in (("pallas_unfused", "total"), ("pallas_items", "items")):
        _reset_launches()
        res = tcim_count(edges, backend=backend)
        launches = _launches()
        windows = math.ceil(pow2_ceil(res.stats["num_pairs"])
                            / clamp_chunk_pairs(1 << 20, MAIN_SLICE_BITS // 32))
        check(res.triangles == want and res.stats["build"] == "device",
              f"ego-facebook {backend}: {res.triangles} ({res.stats['build']}) != oracle {want}")
        check(launches[kernel] == windows and wrappers[kernel].launches == windows,
              f"ego-facebook {backend}: {launches} for {windows} windows")
        log(f"[device build] ego-facebook {backend}: {res.triangles} == oracle over the device "
            f"build, {kernel} launched {launches[kernel]} times ({windows} windows)")


def _time_ms(fn, calls: list, rounds: int) -> float:
    """Mean ms per call of ``fn(*args)`` over ``rounds`` passes of ``calls``."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        for args in calls:
            fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (rounds * len(calls))


def _graph(fn, calls: list, launches: int = GRAPH_LAUNCHES) -> torch.cuda.CUDAGraph:
    """A CUDA graph of ``launches`` launches of ``fn(*args)``, cycling
    through ``calls``: replayed, the kernels run back to back with none of
    the wrapper's host work between them. The wrapper's launch count grows
    by ``launches`` at capture and not at a replay."""
    fn(*calls[0])  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(launches):
            fn(*calls[k % len(calls)])
    return graph


def _graph_uses(k: int, n: int, launches: int = GRAPH_LAUNCHES) -> int:
    """Launches of the ``k``-th of ``n`` calls in a graph from ``_graph``."""
    return len(range(k, launches, n))


def _replay_ms(graph: torch.cuda.CUDAGraph, launches: int = GRAPH_LAUNCHES,
               replays: int = 10) -> float:
    """Device ms a launch: mean over ``replays`` replays of the graph."""
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * launches)


def phase_timing(main: dict) -> tuple:
    """Kernel vs plain at the main path's shapes (W=2, P=1<<20 chunks over
    the com-youtube stores); returns the kernel's JSON row, max |err|, and
    the chunks and resident stores for the serve timing phase."""
    from repro_torch.core import Executor
    from repro_torch.core.plan import pow2_ceil
    from repro_torch.kernels.tc_gather_popcount import (
        gather_total_cuda,
        gather_total_reference,
    )

    sb, wl = main["sbf"], main["worklist"]  # the host build of phase 4b
    ex = Executor(sb)  # the resident, pow2-padded stores the main path uses
    row, col = ex.row_data, ex.col_data
    chunks = []
    for ridx, cidx in ex._chunks(wl.pair_row_pos, wl.pair_col_pos):
        chunks.append((torch.from_numpy(ridx).cuda(), torch.from_numpy(cidx).cuda()))
    check(all(len(r) == pow2_ceil(len(r)) for r, _ in chunks), "chunks are pow2 buckets")

    max_err = 0
    totals = []
    bound_s = 0.0
    for ridx, cidx in chunks:
        got, want = _compare(row, col, ridx, cidx)
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"main-path chunk: kernel {got.tolist()} != plain {want.tolist()}")
        totals.append(int(want[0]))
        # Least bytes: both index arrays, each distinct store row named once, out.
        w = row.shape[1]
        rows_read = torch.unique(ridx[(ridx >= 0) & (cidx >= 0)]).numel()
        cols_read = torch.unique(cidx[(ridx >= 0) & (cidx >= 0)]).numel()
        nbytes = 8 * len(ridx) + 4 * w * (rows_read + cols_read) + 8
        ops = 3 * w * len(ridx)  # AND, popc, add per word
        bound_s += max(nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S)
    check(sum(totals) == main["result"].triangles, f"chunk totals {sum(totals)} != count")
    bound_ms = 1e3 * bound_s / len(chunks)

    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    kernel_calls = [(row, col, r, c, out) for r, c in chunks]
    _time_ms(gather_total_cuda, kernel_calls, 1)  # warm-up
    rounds = max(2, math.ceil(20 / len(chunks)))
    wrapper_ms = _time_ms(gather_total_cuda, kernel_calls, rounds)
    # The main path's call: the executor's launcher, bound once a count.
    with torch.cuda.device(out.device):
        launch = ex._launcher.bind(out)
        _time_ms(launch, chunks, 1)
        ms = _time_ms(launch, chunks, rounds)
    graph = _graph(gather_total_cuda, kernel_calls)
    out.zero_()
    graph.replay()
    want = sum(totals[k % len(chunks)] for k in range(GRAPH_LAUNCHES))
    check(out.tolist() == [want, 0], f"graph replay: {out.tolist()} != plain [{want}, 0]")
    device_ms = _replay_ms(graph)
    del graph
    plain_calls = [(row, col, r, c) for r, c in chunks]
    _time_ms(gather_total_reference, plain_calls[:2], 1)
    plain_ms = _time_ms(gather_total_reference, plain_calls, 1)
    stores = sb.row_slice_data.nbytes + sb.col_slice_data.nbytes
    whole = (stores + 8 * wl.num_pairs) / HBM_BYTES_PER_S * 1e3
    log(f"[timing] gather_total: {ms:.6f} ms/chunk over {rounds * len(chunks)} launches "
        f"through the executor's bound launcher (P={len(chunks[0][0])}, W={row.shape[1]}); "
        f"{wrapper_ms:.6f} ms/chunk through gather_total_cuda (every check a call); bound "
        f"{bound_ms:.6f} ms/chunk (bytes), {100 * bound_ms / ms:.2f}% of bound; device time "
        f"alone {device_ms:.6f} ms/chunk ({100 * bound_ms / device_ms:.2f}% of bound; a CUDA "
        f"graph of {GRAPH_LAUNCHES} launches over the chunks, replayed; its sum == plain), so "
        f"the launcher costs {ms - device_ms:.6f} ms a call and gather_total_cuda "
        f"{wrapper_ms - device_ms:.6f}; plain version {plain_ms:.6f} ms/chunk; "
        f"library_ms null (torch has no popcount op)")
    log(f"[timing] whole count: {len(chunks)} chunks x {ms:.6f} ms = {len(chunks) * ms:.6f} ms "
        f"kernel time vs {whole:.6f} ms for stores ({stores} B) + indices read once")
    log(f"[timing] main-path timings_s: {json.dumps(main['result'].timings_s)}")
    log(f"[timing] main-path max_memory_allocated: {main['peak']} bytes")
    row_json = {
        "name": "gather_total",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tc_gather_popcount.cu",
        "replaces": "src/repro/kernels/tc_gather_popcount.py:145",
        "launches": main["launches"],
        "max_abs_err": 0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "device_ms": device_ms,
        "wrapper_ms": wrapper_ms,
    }
    return row_json, max_err, chunks, row, col


def _wrappers() -> dict:
    from repro_torch.kernels.slice_and_popcount import items_cuda, total_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.tc_bitgemm import bitgemm_cuda
    from repro_torch.kernels.tc_dense_mxu import dense_mxu_tc_cuda
    from repro_torch.kernels.tc_gather_popcount import (
        gather_segment_totals_cuda,
        gather_total_cuda,
    )

    return {
        "gather_total": gather_total_cuda,
        "gather_segment_totals": gather_segment_totals_cuda,
        "total": total_cuda,
        "items": items_cuda,
        "bitgemm": bitgemm_cuda,
        "dense_mxu_tc": dense_mxu_tc_cuda,
        "flash_attention": flash_attention_cuda,
    }


def _reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def phase_segment_cases() -> int:
    """gather_segment_totals: kernel == plain version on the card."""
    from repro_torch.core.executor import MultiCountFuture
    from repro_torch.core.plan import pow2_ceil
    from repro_torch.kernels import ops
    from repro_torch.kernels.tc_gather_popcount import (
        gather_segment_totals_cuda,
        gather_segment_totals_reference,
    )

    rng = np.random.default_rng(1)
    max_err = 0
    for w in (1, 2, 4):
        rows_real, cols_real = 20_000, 12_345
        # Stacked stores are pow2-row-padded with zero rows, as the executor
        # uploads them; indices may name the padding (in range, counts 0).
        row = torch.cat([_words(rng, rows_real, w),
                         torch.zeros(pow2_ceil(rows_real) - rows_real, w, dtype=torch.int32, device="cuda")])
        col = torch.cat([_words(rng, cols_real, w),
                         torch.zeros(pow2_ceil(cols_real) - cols_real, w, dtype=torch.int32, device="cuda")])
        for bucket in SEGMENT_BUCKETS:
            for g in (1, 3, 32):
                p = g * bucket
                r = rng.integers(0, row.shape[0], size=p).astype(np.int32)
                c = rng.integers(0, col.shape[0], size=p).astype(np.int32)
                r[rng.random(p) < 0.1] = -1
                c[rng.random(p) < 0.1] = -1
                hot = rng.random(p) < 0.2
                r[hot], c[hot] = 3, 5
                if g > 1:  # all-sentinel trailing segments (padded_graphs)
                    tail = g // 4 * bucket if g > 3 else bucket
                    r[p - tail:], c[p - tail:] = -1, -1
                ridx, cidx = torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda()
                got = gather_segment_totals_cuda(
                    row, col, ridx, cidx,
                    torch.zeros(g, 2, dtype=torch.int32, device="cuda"), bucket=bucket,
                )
                want = gather_segment_totals_reference(row, col, ridx, cidx, bucket=bucket)
                torch.cuda.synchronize()
                got, want = got.cpu(), want.cpu()
                max_err = max(max_err, int((got.long() - want.long()).abs().max()))
                check(torch.equal(got, want),
                      f"segments W={w} bucket={bucket} G={g}: kernel != plain")
                if g > 1:
                    check(int(got[-1].abs().sum()) == 0, "all-sentinel tail segment not 0")
        log(f"[kernels] gather_segment_totals W={w}: buckets {list(SEGMENT_BUCKETS)} x "
            f"G {{1, 3, 32}} == plain")
    # An out-of-range row index in segment 1 of 3: counted there, never
    # read, and raised at MultiCountFuture.result().
    row, col = _words(rng, 1024, 2), _words(rng, 512, 2)
    bucket = 64
    r = rng.integers(0, 1024, size=3 * bucket).astype(np.int32)
    c = rng.integers(0, 512, size=3 * bucket).astype(np.int32)
    r[bucket + 7] = 1024 + 9
    ridx, cidx = torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda()
    out = ops.popcount_and_gather_segment_totals(row, col, ridx, cidx, bucket=bucket)
    want = gather_segment_totals_reference(row, col, ridx, cidx, bucket=bucket)
    check(torch.equal(out.cpu(), want.cpu()) and out[:, 1].tolist() == [0, 1, 0],
          f"out-of-range segment: {out.tolist()} vs {want.tolist()}")
    try:
        MultiCountFuture(out, 3).result()
    except ValueError as e:
        log(f"[kernels] out-of-range fused index raised at MultiCountFuture.result(): {e}")
    else:
        raise RuntimeError("out-of-range fused index did not raise at result()")
    return max(max_err, _group_cases(rng), _wave_out_of_range(rng))


def _segment_batch(rng, w: int, bucket: int, g: int) -> tuple:
    """One fused batch on the card: pow2-padded stores, G segments of
    ``bucket`` pairs with sentinels, a hot pair and (G > 1) all-sentinel
    trailing segments."""
    from repro_torch.core.plan import pow2_ceil

    rows_real, cols_real = int(rng.integers(100, 3000)), int(rng.integers(100, 3000))
    row = torch.cat([_words(rng, rows_real, w), torch.zeros(pow2_ceil(rows_real) - rows_real, w,
                                                            dtype=torch.int32, device="cuda")])
    col = torch.cat([_words(rng, cols_real, w), torch.zeros(pow2_ceil(cols_real) - cols_real, w,
                                                            dtype=torch.int32, device="cuda")])
    p = g * bucket
    r = rng.integers(0, row.shape[0], size=p).astype(np.int32)
    c = rng.integers(0, col.shape[0], size=p).astype(np.int32)
    r[rng.random(p) < 0.1] = -1
    c[rng.random(p) < 0.1] = -1
    hot = rng.random(p) < 0.2
    r[hot], c[hot] = 3, 5
    if g > 1:
        tail = g // 4 * bucket if g > 3 else bucket
        r[p - tail:], c[p - tail:] = -1, -1
    return row, col, torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda(), bucket


def _group_cases(rng) -> int:
    """The grouped segment kernel == its plain version over waves of 1, 3,
    34 and GROUP_CAP + 1 batches of mixed W, bucket and G, each wave in one
    launch for every GROUP_CAP batches; returns max |err|."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tc_gather_popcount import (
        GROUP_CAP,
        gather_segment_groups_reference,
        gather_segment_totals_cuda,
    )

    max_err = 0
    for n in (*GROUP_WAVES, GROUP_CAP + 1):
        batches = [_segment_batch(rng, (1, 2, 4)[k % 3], SEGMENT_BUCKETS[k % len(SEGMENT_BUCKETS)],
                                  (1, 3, 32)[k % 3]) for k in range(n)]
        before = gather_segment_totals_cuda.launches
        got = ops.popcount_and_gather_segment_groups(batches)
        launches = gather_segment_totals_cuda.launches - before
        want = gather_segment_groups_reference(batches)
        torch.cuda.synchronize()
        got, want = got.cpu(), want.cpu()
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"grouped wave of {n} batches: kernel != plain")
        check(launches == math.ceil(n / GROUP_CAP), f"wave of {n} batches took {launches} launches")
        log(f"[kernels] grouped segments: a wave of {n} batches (W 1/2/4, buckets "
            f"{sorted({b[4] for b in batches})}, G 1/3/32, all-sentinel tails) == plain in "
            f"{launches} launch(es)")
    return max_err


def _wave_out_of_range(rng) -> int:
    """An out-of-range index in one batch of a fused wave: counted in that
    batch's rows, raised at its future's result() and at no other's."""
    from repro_torch.core import MultiGraphExecutor, build_sbf, build_worklist
    from repro_torch.graphs import build_graph, rmat, triangles_intersection
    from repro_torch.kernels.tc_gather_popcount import gather_segment_totals_cuda

    multi = MultiGraphExecutor()
    job_lists, want = [], []
    for k in range(5):
        jobs, counts = [], []
        for i in range(1 + 3 * k):
            g = build_graph(rmat(64 << (k % 3), 6 * (64 << (k % 3)), seed=1000 * k + i))
            sb = build_sbf(g, (32, 64, 128)[k % 3])
            jobs.append((sb, build_worklist(g, sb)))
            counts.append(triangles_intersection(g))
        job_lists.append(jobs)
        want.append(tuple(counts))
    batches = [multi.prepare(jobs) for jobs in job_lists]
    victim = 2
    ridx = batches[victim].ridx
    first_real = int(torch.nonzero(ridx >= 0)[0])
    ridx[first_real] = batches[victim].row_data.shape[0] + 7
    before = gather_segment_totals_cuda.launches
    futures = multi.dispatch(batches)
    check(gather_segment_totals_cuda.launches - before == 1, "the wave was not one launch")
    for k, fut in enumerate(futures):
        if k == victim:
            try:
                fut.result()
            except ValueError as e:
                log(f"[kernels] out-of-range index in batch {k} of a wave of {len(futures)} "
                    f"raised at its result() only: {e}")
            else:
                raise RuntimeError("out-of-range index in a wave did not raise at its result()")
        else:
            check(fut.result() == want[k], f"wave batch {k}: {fut.result()} != {want[k]}")
    return 0


def phase_unfused_cases() -> int:
    """total and items: kernel == plain version on the card, up to the
    executor's chunk (1<<20 pairs), with an unaligned operand for total."""
    from repro_torch.kernels.slice_and_popcount import (
        items_cuda,
        items_reference,
        total_cuda,
        total_reference,
    )

    rng = np.random.default_rng(2)
    max_err = 0
    for w in (1, 2, 4):
        for p in (1, 3, 1001, 1 << 16, 1 << 20):
            rows, cols = _words(rng, p, w), _words(rng, p, w)
            rows[: p // 3] = 0  # masked (sentinel) pairs gather zeros
            tot = total_cuda(rows, cols, torch.zeros(1, dtype=torch.int32, device="cuda"))
            items = items_cuda(rows, cols, torch.empty(p, dtype=torch.int32, device="cuda"))
            want_tot, want_items = total_reference(rows, cols), items_reference(rows, cols)
            torch.cuda.synchronize()
            err = max(abs(int(tot) - int(want_tot)),
                      int((items.long() - want_items.long()).abs().max()))
            max_err = max(max_err, err)
            check(int(tot) == int(want_tot), f"total W={w} P={p}: {int(tot)} != {int(want_tot)}")
            check(torch.equal(items.cpu(), want_items.cpu()), f"items W={w} P={p}: kernel != plain")
        log(f"[kernels] total and items W={w}: P 1 .. 1<<20 == plain")
    flat = _words(rng, 4097, 1)  # a one-word offset: the kernel's scalar path
    a, b = flat[1:], _words(rng, 4096, 1)
    got = total_cuda(a, b, torch.zeros(1, dtype=torch.int32, device="cuda"))
    check(int(got) == int(total_reference(a, b)), "total on an unaligned operand")
    log("[kernels] total on a 4-byte-aligned (not 16-byte) operand == plain")
    return max_err


def _fleet() -> tuple[list, list]:
    """The serve phase's jobs: 512 + 16 + 16 small rmat tenants, then the
    three full-size solo graphs. Returns (jobs, exact oracle counts)."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import build_sbf, build_worklist
    from repro_torch.graphs import build_graph, rmat, triangles_intersection

    specs = [(i, 64) for i in range(NUM_TENANTS)]
    specs += [(NUM_TENANTS + i, 32) for i in range(NUM_TENANTS_SIDE)]
    specs += [(NUM_TENANTS + NUM_TENANTS_SIDE + i, 128) for i in range(NUM_TENANTS_SIDE)]
    jobs, exact = [], []
    for seed, bits in specs:
        n = MIX_N[seed % len(MIX_N)]
        g = build_graph(rmat(n, EDGE_FACTOR * n, seed=seed))
        sb = build_sbf(g, bits)
        jobs.append((sb, build_worklist(g, sb)))
        exact.append(triangles_intersection(g))
    for name in SOLO_GRAPHS:
        g = build_graph(_edges(GRAPHS[name]), reorder=True)
        sb = build_sbf(g, MAIN_SLICE_BITS)
        jobs.append((sb, build_worklist(g, sb)))
        exact.append(triangles_intersection(g))
    return jobs, exact


def _by_id(results) -> list:
    return sorted(results, key=lambda r: r.request_id)


def _check_serve(results, want, label: str) -> None:
    check(len(results) == len(want), f"{label}: {len(results)} results for {len(want)} jobs")
    for r, c in zip(results, want):
        check(r.status == "ok" and r.count == c,
              f"{label}: request {r.request_id} {r.status} {r.count} != {c} ({r.detail})")


def phase_serve() -> dict:
    """TCServer on the card over the fleet, held against the exact oracle
    and the port's CPU server; cache, modes, budget and fault runs."""
    from repro_torch.core.plan import clamp_chunk_pairs
    from repro_torch.kernels.tc_gather_popcount import GROUP_CAP
    from repro_torch.launch.tc_serve import ServeConfig, TCServer
    from repro_torch.runtime.fault import FailureInjector

    t0 = time.perf_counter()
    jobs, exact = _fleet()
    build_s = time.perf_counter() - t0
    solos = len(SOLO_GRAPHS)
    log(f"[serve] fleet: {len(jobs) - solos} tenants + {solos} full-size graphs, host build "
        f"and exact oracle {build_s:.3f} s; pairs "
        f"{min(wl.num_pairs for _, wl in jobs[:-solos])}..{max(wl.num_pairs for _, wl in jobs[:-solos])} "
        f"(tenants), {[wl.num_pairs for _, wl in jobs[-solos:]]} (solos)")
    # ServeConfig's defaults, with room in the batch cache for every batch
    # of the fleet (the default keeps 8), so the re-serve can hit them all.
    cfg = ServeConfig(fused_max_batches=64)

    srv = TCServer(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    results = _by_id(srv.serve(jobs))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    stats = srv.server_stats()
    log(f"[serve] card, cold: {len(results)} results in {cold_s:.6f} s; launches {launches}")
    log(f"[serve] server_stats: {json.dumps(stats)}")
    log(f"[serve] max_memory_allocated: {peak} bytes")
    _check_serve(results, exact, "card serve")
    # One wave (the default budget admits the fleet), whose fused batches of
    # every word width share one launch for every GROUP_CAP of them.
    wave_launches = math.ceil(stats["fused_batches"] / GROUP_CAP)
    check(stats["waves"] == 1 and stats["fused_batches"] > 0, f"serve stats {stats}")
    check(launches["gather_segment_totals"] == wave_launches,
          f"segment launches {launches['gather_segment_totals']} != {wave_launches} for a wave "
          f"of {stats['fused_batches']} fused batches")
    solo_chunks = sum(
        math.ceil(wl.num_pairs / clamp_chunk_pairs(cfg.chunk_pairs, sb.words_per_slice))
        for sb, wl in jobs if wl.num_pairs > cfg.max_fused_pairs
    )
    check(launches["gather_total"] == solo_chunks > 0,
          f"gather_total launches {launches['gather_total']} != solo chunks {solo_chunks}")
    for r, (_, wl) in zip(results, jobs):
        want = "fused" if wl.num_pairs <= cfg.max_fused_pairs else "replicated"
        check(r.placement == want, f"request {r.request_id}: {r.placement}, expected {want}")
    log(f"[serve] every count == exact oracle; {stats['fused_batches']} fused batches "
        f"({stats['fused_graphs']} graphs), {stats.get('solo_replicated', 0)} solos")

    t0 = time.perf_counter()
    cpu = _by_id(TCServer(ServeConfig(device="cpu", fused_max_batches=64)).serve(jobs))
    cpu_s = time.perf_counter() - t0
    check([r.count for r in cpu] == [r.count for r in results], "CPU server counts differ")
    log(f"[serve] port CPU server: same {len(cpu)} counts in {cpu_s:.3f} s")

    uploads = srv.multi.upload_bytes
    before = srv.server_stats()["fused"]
    _reset_launches()
    t0 = time.perf_counter()
    again = _by_id(srv.serve(jobs))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    after = srv.server_stats()["fused"]
    batches = srv.stats["fused_batches"] - stats["fused_batches"]
    again_launches = _launches()
    _check_serve(again, exact, "cached re-serve")
    check(after["hits"] - before["hits"] == batches and after["misses"] == before["misses"],
          f"re-serve: {after} after {before} for {batches} batches")
    check(srv.multi.upload_bytes == uploads, "re-serve uploaded to the device")
    check(again_launches["gather_segment_totals"] == math.ceil(batches / GROUP_CAP),
          f"re-serve: segment launches {again_launches} for {batches} batches")
    log(f"[serve] cached re-serve: {batches} batch-cache hits, 0 new upload bytes, "
        f"{warm_s:.6f} s; launches {again_launches}")

    solo = [i for i, (_, wl) in enumerate(jobs) if wl.num_pairs > cfg.max_fused_pairs]
    solo_jobs, solo_exact = [jobs[i] for i in solo], [exact[i] for i in solo]
    mode_launches = {}
    for mode, kernel in (("gather_then_kernel", "total"), ("pallas_items", "items")):
        _reset_launches()
        res = _by_id(TCServer(ServeConfig(mode=mode)).serve(solo_jobs))
        torch.cuda.synchronize()
        got = _launches()
        _check_serve(res, solo_exact, f"mode {mode}")
        check(got[kernel] == solo_chunks and got["gather_total"] == 0,
              f"mode {mode}: launches {got} for {solo_chunks} chunks")
        mode_launches[kernel] = got[kernel]
        log(f"[serve] mode {mode} on the solos: counts == oracle; launches {got}")

    foot = sorted(_footprint(sb, wl, cfg.chunk_pairs) for sb, wl in jobs)
    budget = foot[-2]  # the largest request can never fit
    tight = TCServer(ServeConfig(memory_budget_bytes=budget, fused_max_batches=64))
    res = _by_id(tight.serve(jobs))
    rejected = [r for r in res if r.status == "rejected"]
    check(len(res) == len(jobs) and len(rejected) >= 1, "tight budget rejected nothing")
    check(all("exceeds budget" in r.detail for r in rejected), "rejection detail")
    for r, c in zip(res, exact):
        check(r.status == "rejected" or (r.status == "ok" and r.count == c),
              f"tight budget: request {r.request_id} {r.status} {r.count} != {c}")
    log(f"[serve] budget {budget} B: {len(rejected)} rejected and reported, the other "
        f"{len(res) - len(rejected)} exact, {tight.stats['waves']} waves")

    victim = 37
    inj = TCServer(ServeConfig(injector=FailureInjector(fail_at_steps=(victim,)),
                               fused_max_batches=64))
    _reset_launches()
    res = _by_id(inj.serve(jobs))
    inj_launches = _launches()
    _check_serve(res, exact, "injected failure")
    check(res[victim].retries >= 1 and "recovered" in res[victim].detail,
          f"request {victim}: {res[victim]}")
    # The failed batch stays out of the wave's launch; the others share it.
    check(inj.stats["fused_batches"] == stats["fused_batches"] - 1
          and inj_launches["gather_segment_totals"] == wave_launches,
          f"injected failure: {inj.stats} and launches {inj_launches}")
    log(f"[serve] injected failure on request {victim}: {res[victim].detail}, "
        f"{inj.stats['wave_failures']} wave failure(s), the other "
        f"{inj.stats['fused_batches']} batches in {wave_launches} launch(es), every count exact")
    return {
        "jobs": jobs, "server": srv, "launches": launches, "mode_launches": mode_launches,
        "build_s": build_s, "cold_s": cold_s, "warm_s": warm_s, "cpu_s": cpu_s, "peak": peak,
        "exact": exact,
    }


def _footprint(sb, wl, chunk_pairs: int) -> int:
    from repro_torch.launch.tc_serve import ServeRequest

    return ServeRequest(0, sb, wl, 0.0).footprint_bytes(chunk_pairs)


def _bound_ms(nbytes: float, ops: float, ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _row(name, source, replaces, launches, ms, plain_ms, bound, library_ms=None) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
    }


def phase_serve_timing(serve: dict, chunks, row, col) -> tuple[list, int]:
    """Kernel vs plain for the segment, total and items kernels at the
    paths' shapes; fused serving vs the per-graph loop; returns the JSON
    rows and the max |err|."""
    from repro_torch.core.executor import ExecutorPool, _gather_chunk
    from repro_torch.kernels.slice_and_popcount import (
        items_cuda,
        items_reference,
        total_cuda,
        total_reference,
    )
    from repro_torch.kernels.tc_gather_popcount import (
        gather_segment_groups_cuda,
        gather_segment_groups_reference,
        gather_segment_totals_cuda,
    )

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    srv = serve["server"]
    # The fleet's wave: every cached batch, in one grouped launch (the
    # executor's cached table) into one zeroed output; beside it the same
    # batches as one-entry launches in turns ("no grouping").
    batches = list(srv.multi._batches.values())
    table = srv.multi._table(batches)
    segs = [b.segments for b in batches]
    wave_out = torch.zeros(table.rows, 2, dtype=torch.int32, device="cuda")
    wave = lambda out: [gather_segment_groups_cuda(table, out, k)  # noqa: E731
                        for k in range(len(table.groups))]
    want = gather_segment_groups_reference(segs)
    wave(wave_out)
    torch.cuda.synchronize()
    max_err = int((wave_out.cpu().long() - want.cpu().long()).abs().max())
    check(max_err == 0, "fleet wave: grouped segment kernel != plain")
    _time_ms(wave, [(wave_out,)], 1)
    seg_ms = _time_ms(wave, [(wave_out,)], 20)
    # The executor's whole wave dispatch: zeroed output, the launch, the futures.
    _time_ms(srv.multi.dispatch, [(batches,)], 1)
    dispatch_ms = _time_ms(srv.multi.dispatch, [(batches,)], 20)
    launches = WAVE_GRAPH_LAUNCHES
    graph = _graph(wave, [(wave_out,)], launches)
    wave_out.zero_()
    graph.replay()
    check(torch.equal(wave_out.long(), launches * want.long()),
          "fleet wave: the grouped kernel's graph replay != plain")
    seg_device_ms = _replay_ms(graph, launches)
    del graph
    single = [(*seg[:4], torch.zeros(b.plan.padded_graphs, 2, dtype=torch.int32, device="cuda"),
               seg[4]) for seg, b in zip(segs, batches)]
    one = lambda *a: gather_segment_totals_cuda(*a[:5], bucket=a[5])  # noqa: E731
    _time_ms(one, single, 1)
    one_ms = _time_ms(one, single, 3) * len(single)
    each = len(single) * math.ceil(GRAPH_LAUNCHES / len(single))
    graph = _graph(one, single, each)
    for a in single:
        a[4].zero_()
    graph.replay()
    check(torch.cat([a[4] for a in single]).long().equal(
        (each // len(single)) * want.long()), "fleet batches one by one: graph replay != plain")
    one_device_ms = _replay_ms(graph, each) * len(single)
    del graph
    plain = gather_segment_groups_reference
    _time_ms(plain, [(segs,)], 1)
    seg_plain_ms = _time_ms(plain, [(segs,)], 3)
    seg_ms_bound, seg_by = 0.0, "bytes"
    for b in batches:
        valid = (b.ridx >= 0) & (b.cidx >= 0)
        w = b.row_data.shape[1]
        rows_read = torch.unique(b.ridx[valid]).numel()
        cols_read = torch.unique(b.cidx[valid]).numel()
        t, seg_by = _bound_ms(8 * b.ridx.numel() + 4 * w * (rows_read + cols_read)
                              + 8 * b.plan.padded_graphs, 3 * w * int(valid.sum()))
        seg_ms_bound += t
    seg_bound = (seg_ms_bound, seg_by)
    seg_bytes = sum(8 * b.ridx.numel() + 4 * (b.row_data.numel() + b.col_data.numel())
                    for b in batches)
    shapes = sorted({(b.plan.padded_graphs, b.plan.bucket, b.plan.words_per_slice) for b in batches})
    lanes = sum(b.ridx.numel() for b in batches)
    log(f"[timing] gather_segment_totals: a serve wave of the fleet's {len(batches)} cached "
        f"batches ((G, bucket, W) in {shapes}; {lanes} index lanes, {table.groups[-1].first_block[-1]} "
        f"blocks; {seg_bytes} B of indices and stores in all, L2 "
        f"{l2} B) in {len(table.groups)} grouped launch(es): {seg_ms:.6f} ms a wave per call "
        f"(gather_segment_groups_cuda on the cached table into one zeroed output), "
        f"{dispatch_ms:.6f} ms a wave through MultiGraphExecutor.dispatch (zeroing, launch, "
        f"futures); bound {seg_bound[0]:.6f} ms a wave ({seg_bound[1]}), "
        f"{100 * seg_bound[0] / seg_ms:.2f}% of bound per call; device time alone "
        f"{seg_device_ms:.6f} ms a wave ({100 * seg_bound[0] / seg_device_ms:.2f}% of bound; a "
        f"CUDA graph of {launches} whole-wave launches, replayed; its sums == plain), so the "
        f"wrapper costs {seg_ms - seg_device_ms:.6f} ms a call; no grouping (one launch a "
        f"batch, in turns): {one_ms:.6f} ms a wave per call, {one_device_ms:.6f} ms of device "
        f"time alone ({one_device_ms / len(single):.6f} ms a batch); plain version "
        f"{seg_plain_ms:.6f} ms a wave; library_ms null ({NO_POPCOUNT_OP})")

    # total and items at the executor's chunk shape for com-youtube, over
    # every chunk in turns: their gathered words are larger than L2, so each
    # launch reads its operands from device memory, as on the path.
    acc = torch.zeros(2, dtype=torch.int32, device="cuda")
    gathered = [_gather_chunk(row, col, ridx, cidx, acc) for ridx, cidx in chunks]
    words_bytes = sum(2 * r.numel() * 4 for r, _ in gathered)
    p, w = gathered[0][0].shape
    rows_json = []
    for name, kernel, plain_fn, replaces in (
        ("total", total_cuda, total_reference, "src/repro/kernels/slice_and_popcount.py:90"),
        ("items", items_cuda, items_reference, "src/repro/kernels/slice_and_popcount.py:41"),
    ):
        calls = [(rows, cols, torch.zeros(1 if name == "total" else rows.shape[0],
                                          dtype=torch.int32, device="cuda"))
                 for rows, cols in gathered]
        wants = [plain_fn(rows, cols).long().reshape(-1) for rows, cols in gathered]
        err = 0
        for args, want in zip(calls, wants):
            got = kernel(*args)
            torch.cuda.synchronize()
            err = max(err, int((got.long().reshape(-1) - want).abs().max()))
        check(err == 0, f"{name} at the chunk shape: kernel != plain")
        max_err = max(max_err, err)
        rounds = math.ceil(50 / len(calls))
        _time_ms(kernel, calls, 1)
        ms = _time_ms(kernel, calls, rounds)
        graph = _graph(kernel, calls)
        for args in calls:
            args[2].zero_()
        graph.replay()
        # total adds into out; items overwrites it
        check(all(torch.equal(args[2].long().reshape(-1),
                              (_graph_uses(k, len(calls)) if name == "total" else 1) * want)
                  for k, (args, want) in enumerate(zip(calls, wants))),
              f"{name}: the graph replay != plain")
        device_ms = _replay_ms(graph)
        del graph
        plain_calls = [(rows, cols) for rows, cols in gathered]
        _time_ms(plain_fn, plain_calls[:1], 1)
        plain_ms = _time_ms(plain_fn, plain_calls, 1)
        each = [_bound_ms(2 * r.numel() * 4 + (4 if name == "total" else 4 * r.shape[0]),
                          3 * r.numel()) for r, _ in gathered]
        bound = (sum(t for t, _ in each) / len(each), each[0][1])
        log(f"[timing] {name}: {ms:.6f} ms/launch over the {len(calls)} com-youtube chunks in "
            f"turns (P={p}, W={w}; {words_bytes} B of gathered words in all, L2 {l2} B); "
            f"bound {bound[0]:.6f} ms a chunk ({bound[1]}), {100 * bound[0] / ms:.2f}% of bound; "
            f"device time alone {device_ms:.6f} ms ({100 * bound[0] / device_ms:.2f}% of bound; a "
            f"CUDA graph of {GRAPH_LAUNCHES} launches over the chunks, replayed; == plain), so the "
            f"wrapper costs {ms - device_ms:.6f} ms a call; plain version {plain_ms:.6f} ms; "
            f"library_ms null ({NO_POPCOUNT_OP})")
        r = _row(name, "src/repro_torch/kernels/csrc/slice_and_popcount.cu",
                 replaces, serve["mode_launches"][name], ms, plain_ms, bound)
        r["device_ms"] = device_ms
        rows_json.append(r)
    del gathered

    # Steady state: fused serve() vs the per-graph pool loop, same tenants.
    tenants = serve["jobs"][:NUM_TENANTS]
    pool = ExecutorPool(max_graphs=2 * NUM_TENANTS)

    def loop_round():
        futs = [pool.count_async(sb, wl) for sb, wl in tenants]
        return [f.result() for f in futs]

    def fused_round():
        return [r.count for r in _by_id(srv.serve(tenants))]

    check(loop_round() == fused_round(), "pool loop and fused serve differ")
    rounds = 5
    gps = {"fused": [], "loop": []}
    for kind in ("fused", "loop", "loop", "fused"):
        fn = fused_round if kind == "fused" else loop_round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
        gps[kind].append(rounds * len(tenants) / (time.perf_counter() - t0))
    fused_gps, loop_gps = sum(gps["fused"]) / 2, sum(gps["loop"]) / 2
    log(f"[timing] steady state over {len(tenants)} tenants x {rounds} rounds, in turns "
        f"fused, loop, loop, fused: serve() {gps['fused']} graphs/s, pool loop {gps['loop']} "
        f"graphs/s; means {fused_gps:.3f} vs {loop_gps:.3f} ({fused_gps / loop_gps:.3f}x)")

    # Where a serve wave's time goes: its dispatch and its one readback.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futures = srv.multi.dispatch(batches)
    t1 = time.perf_counter()
    counts = [f.result() for f in futures]
    t2 = time.perf_counter()
    check(all(len(c) == b.plan.num_graphs for c, b in zip(counts, batches)), "wave readback")
    log(f"[timing] serve stages: fleet host build + oracle {serve['build_s']:.3f} s; cold "
        f"serve {serve['cold_s']:.6f} s; cached re-serve {serve['warm_s']:.6f} s; the "
        f"{len(batches)} cached batches' wave dispatched in {1e3 * (t1 - t0):.6f} ms and read back "
        f"in {1e3 * (t2 - t1):.6f} ms (host clock); CPU server {serve['cpu_s']:.3f} s; peak "
        f"memory {serve['peak']} bytes")
    seg_row = _row("gather_segment_totals", "src/repro_torch/kernels/csrc/tc_gather_popcount.cu",
                   "src/repro/kernels/tc_gather_popcount.py:239",
                   serve["launches"]["gather_segment_totals"], seg_ms, seg_plain_ms, seg_bound)
    seg_row["device_ms"] = seg_device_ms
    seg_row["per"] = "serve wave"
    seg_row["batches"] = len(batches)
    seg_row["no_grouping_ms"] = one_ms
    seg_row["no_grouping_device_ms"] = one_device_ms
    return [seg_row, *rows_json], max_err


def _dense_case(n: int, density: float, seed: int, kind: str) -> torch.Tensor:
    """An [n, n] {0,1} bool matrix on the card: strictly upper- or
    lower-triangular, full, or block-sparse (full {0,1} with random 128-row
    tile rows and columns zeroed: an occupancy plan that is not the
    triangle)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(n, n, generator=gen, device="cuda") < density
    if kind == "upper":
        return torch.triu(a, 1)
    if kind == "lower":
        return torch.tril(a, -1)
    if kind == "block-sparse":
        nt = -(-n // 128)
        rows = (torch.rand(nt, generator=gen, device="cuda") < 0.6).repeat_interleave(128)[:n]
        cols = (torch.rand(nt, generator=gen, device="cuda") < 0.6).repeat_interleave(128)[:n]
        return a & rows[:, None] & cols[None, :]
    return a


def _planned_steps(a: torch.Tensor) -> int:
    """The k steps the occupancy plan keeps (the plain plan helper)."""
    from repro_torch.kernels.tc_dense_mxu import dense_mxu_occupancy_reference, dense_mxu_plan

    return int(dense_mxu_plan(dense_mxu_occupancy_reference(a))[1].sum())


def phase_dense_cases() -> tuple[int, int]:
    """bitgemm and dense_mxu_tc: kernel == plain version on the card.
    Returns the max |err| of each."""
    from repro_torch.kernels.tc_bitgemm import bitgemm_cuda, bitgemm_reference, padded_view
    from repro_torch.kernels.tc_dense_mxu import dense_mxu_tc_cuda, dense_mxu_tc_reference

    rng = np.random.default_rng(3)
    err_bitgemm = 0
    copies = 0
    for w in BITGEMM_WORDS:
        for i in BITGEMM_SIZES:
            for j in BITGEMM_SIZES:
                for pattern in ("random", "zeros", "ones"):
                    if pattern == "ones":
                        x = torch.full((i, w), -1, dtype=torch.int32, device="cuda")
                        y = torch.full((j, w), -1, dtype=torch.int32, device="cuda")
                    else:
                        x, y = _words(rng, i, w), _words(rng, j, w)
                        if pattern == "zeros":
                            x.zero_()
                    want = bitgemm_reference(x, y)
                    # Contiguous operands: a row stride of W words, copied to
                    # padded scratch unless W is a multiple of 4; then the
                    # row-padded views tcim hands over, read as they lie.
                    for layout in ("contiguous", "padded"):
                        if layout == "padded":
                            x, y = padded_view(x, fill=-1), padded_view(y, fill=-1)
                        before = bitgemm_cuda.padded_copies
                        got = bitgemm_cuda(x, y, torch.empty(i, j, dtype=torch.int32, device="cuda"))
                        torch.cuda.synchronize()
                        made = bitgemm_cuda.padded_copies - before
                        copies += made
                        expect = 2 if layout == "contiguous" and w % 4 else 0
                        check(made == expect, f"bitgemm I={i} J={j} W={w} {layout}: {made} padded "
                                              f"copies, expected {expect}")
                        err = int((got.long() - want.long()).abs().max())
                        err_bitgemm = max(err_bitgemm, err)
                        check(err == 0, f"bitgemm I={i} J={j} W={w} {pattern} {layout}: kernel != plain")
                        if pattern == "ones":
                            check(bool((got == 32 * w).all()), f"bitgemm all-ones I={i} J={j} W={w}")
        log(f"[dense] bitgemm W={w}: I, J in {list(BITGEMM_SIZES)} x random/zero/all-ones x "
            f"contiguous/row-padded == plain")
    log(f"[dense] bitgemm: {copies} operands copied to padded scratch, the contiguous ones whose "
        f"W is not a multiple of 4; none of the row-padded views")
    x = _words(rng, 129, 5)
    for label, args in (("a transposed operand (words not consecutive)", (x.t(), x.t())),
                        ("an int64 operand", (x.long(), x.long())),
                        ("a host operand", (x, x.cpu()))):
        n_out = args[0].shape[0]
        try:
            bitgemm_cuda(*args, torch.empty(n_out, n_out, dtype=torch.int32, device="cuda"))
        except (ValueError, TypeError) as e:
            log(f"[dense] bitgemm refused {label}: {e}")
        else:
            raise RuntimeError(f"bitgemm took {label}")

    err_mxu = 0
    cases = [(n, d, "upper") for n in MXU_SIZES for d in MXU_DENSITIES]
    cases += [(n, d, "lower") for n in MXU_SIZES for d in (0.02, 0.3)]
    cases += [(n, 0.5, kind) for n in (255, 257, 1000, 4039) for kind in ("full", "block-sparse")]
    skipped = {}
    for k, (n, density, kind) in enumerate(cases):
        a = _dense_case(n, density, seed=k, kind=kind)
        steps = torch.zeros(1, dtype=torch.int64, device="cuda")
        got = dense_mxu_tc_cuda(a.to(torch.int8), torch.zeros(1, dtype=torch.int64, device="cuda"),
                                steps)
        want = dense_mxu_tc_reference(a)
        torch.cuda.synchronize()
        err = abs(int(got) - int(want))
        err_mxu = max(err_mxu, err)
        planned = _planned_steps(a)
        check(err == 0, f"dense_mxu_tc N={n} density={density} {kind}: "
                        f"kernel {int(got)} != plain {int(want)}")
        check(int(steps) == planned, f"dense_mxu_tc N={n} {kind}: {int(steps)} k steps computed, "
                                     f"the plan keeps {planned}")
        if n == 4039:
            nt = -(-n // 128)
            skipped[kind] = f"{planned} of {nt ** 3} k steps"
    log(f"[dense] dense_mxu_tc: N in {list(MXU_SIZES)} x densities {list(MXU_DENSITIES)} "
        f"(upper-triangular), lower-triangular, full and block-sparse {{0,1}} N 255 / 257 / "
        f"1000 / 4039 == plain; k steps computed == the plan's in every case; at N 4039: "
        f"{json.dumps(skipped)}")
    return err_bitgemm, err_mxu


def _dense_operands(g, backend: str) -> float:
    """Seconds to build one dense backend's operands on the card with
    tcim's own builders (packing on the host and an upload for bitgemm, a
    scatter on the card for mxu), up to the first kernel."""
    from repro_torch.core.tcim import _bitgemm_operands, _dense_upper

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_bitgemm_operands if backend == "bitgemm" else _dense_upper)(g, torch.device("cuda"))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_dense(cpu_paths: tuple) -> dict:
    """The dense backends on the card at full size, held against the exact
    oracle (and, on ego-facebook, the port's CPU path, counted by the
    "cpu-paths" host child); the analytics."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import baselines, metrics, tcim_count
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.kernels.tc_bitgemm import bitgemm_cuda

    out = {}
    for name in DENSE_GRAPHS:
        edges = _edges(GRAPHS[name])
        g = build_graph(edges, reorder=True)
        t0 = time.perf_counter()
        exact = triangles_intersection(g)
        log(f"[dense] {name}: |V|={g.n} |E|={g.m}; exact oracle {exact} in "
            f"{time.perf_counter() - t0:.3f} s")
        chunks = sum(
            int(g.indptr[min(s + BITGEMM_CHUNK_ROWS, g.n)] > g.indptr[s])
            for s in range(0, g.n, BITGEMM_CHUNK_ROWS)
        )
        for backend in DENSE_BACKENDS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()  # what earlier phases still hold
            copies = bitgemm_cuda.padded_copies
            _reset_launches()
            t0 = time.perf_counter()
            res = tcim_count(edges, backend=backend)
            wall = time.perf_counter() - t0
            launches = _launches()
            peak = torch.cuda.max_memory_allocated() - base
            kernel = "bitgemm" if backend == "bitgemm" else "dense_mxu_tc"
            want = chunks if backend == "bitgemm" else 1
            others = {k: v for k, v in launches.items() if k != kernel and v}
            check(launches[kernel] == want and not others,
                  f"{name} {backend}: launches {launches}, expected {want} of {kernel}")
            check(bitgemm_cuda.padded_copies == copies,
                  f"{name} {backend}: tcim's row-padded operands were copied")
            check(res.triangles == exact, f"{name} {backend}: card {res.triangles} != oracle {exact}")
            build_s = _dense_operands(g, backend)
            log(f"[dense] {name} {backend}: card {res.triangles} == oracle; {launches[kernel]} "
                f"{kernel} launches; {wall:.6f} s wall; timings_s {json.dumps(res.timings_s)}; "
                f"operand build alone {build_s:.6f} s; max_memory_allocated {peak} bytes above "
                f"the {base} bytes held before")
            if name == "ego-facebook":
                cpu = _child_result(cpu_paths, "dense.json", MAIN_ORACLE_TIMEOUT)[backend]
                check(cpu["triangles"] == exact,
                      f"{name} {backend}: CPU {cpu['triangles']} != {exact}")
                log(f"[dense] {name} {backend}: port CPU path (in the host child) "
                    f"{cpu['triangles']} == card, {cpu['wall']:.3f} s")
            else:
                work = ("a float64 A @ A of about 10^14 operations" if backend == "mxu"
                        else f"{g.n * g.n * -(-g.n // 32):.3e} SWAR popcounts")
                log(f"[dense] {name} {backend}: the port's CPU path is left out at this size "
                    f"({work} on the host)")
            out[(name, backend)] = {"launches": launches[kernel], "result": res, "peak": peak,
                                    "build_s": build_s, "wall": wall}
        out[name] = g

    g = out["ego-facebook"]
    _reset_launches()
    support = metrics.edge_support(g)
    launches = _launches()
    check(launches["items"] == 1, f"edge_support launches {launches}")
    check(np.array_equal(support, metrics.edge_support(g, device="cpu")), "edge_support card != CPU")
    check(int(support.sum()) == out[("ego-facebook", "mxu")]["result"].triangles,
          "edge support does not sum to the count")
    log(f"[dense] ego-facebook edge_support: 1 items launch; == CPU path; sums to the count")
    mm = baselines.matmul_tc(g)
    check(mm == out[("ego-facebook", "mxu")]["result"].triangles, f"matmul_tc {mm}")
    log(f"[dense] ego-facebook baselines.matmul_tc on the card: {mm} == oracle")
    return out


def _int_mm_ms(a8: torch.Tensor) -> float | None:
    """torch._int_mm (the product alone) of the int8 operand padded to a
    multiple of 8, as the library needs; None if the library refuses."""
    n = a8.shape[0]
    m = -(-n // 8) * 8
    pad = torch.zeros(m, m, dtype=torch.int8, device="cuda")
    pad[:n, :n] = a8
    try:
        torch._int_mm(pad, pad)
    except RuntimeError as e:
        log(f"[dense timing] torch._int_mm refused N={m}: {e}")
        return None
    _time_ms(torch._int_mm, [(pad, pad)], 1)
    return _time_ms(torch._int_mm, [(pad, pad)], 3)


def _bits_int8(words: torch.Tensor, rows: int, chunk: int = 4096) -> torch.Tensor:
    """``[R, W]`` int32 words -> ``[rows, 32 W]`` int8 {0,1}, bit b of word w
    at column 32 w + b, unpacked ``chunk`` rows at a time; rows past R are
    zero."""
    r, w = words.shape
    out = torch.zeros(rows, 32 * w, dtype=torch.int8, device=words.device)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    for s in range(0, r, chunk):
        blk = words[s : s + chunk]
        out[s : s + blk.shape[0]] = ((blk[:, :, None] >> shifts) & 1).to(torch.int8).reshape(
            blk.shape[0], 32 * w)
    return out


def _int_mm_bits_ms(x: torch.Tensor, y: torch.Tensor, kernel_out: torch.Tensor
                    ) -> tuple[float | None, float]:
    """torch._int_mm (the product alone) of x's bits by y's bits transposed,
    as {0,1} int8 (J padded to a multiple of 8, as the library needs),
    checked equal to the kernel's ``kernel_out``; None if the library
    refuses. Also the seconds the unpacking took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xb = _bits_int8(x, x.shape[0])
    yb = _bits_int8(y, -(-y.shape[0] // 8) * 8)
    torch.cuda.synchronize()
    unpack_s = time.perf_counter() - t0
    try:
        prod = torch._int_mm(xb, yb.t())
    except RuntimeError as e:
        log(f"[dense timing] torch._int_mm refused [{xb.shape[0]}, {xb.shape[1]}] x "
            f"[{yb.shape[1]}, {yb.shape[0]}]: {e}")
        return None, unpack_s
    check(torch.equal(prod[:, : y.shape[0]], kernel_out),
          "torch._int_mm on the bits != the bitgemm kernel")
    del prod
    _time_ms(torch._int_mm, [(xb, yb.t())], 1)
    return _time_ms(torch._int_mm, [(xb, yb.t())], 3), unpack_s


def phase_dense_timing(dense: dict) -> list:
    """Kernel vs plain at the dense paths' shapes; returns the JSON rows."""
    from repro_torch.core.tcim import _bitgemm_operands, _dense_upper
    from repro_torch.kernels.tc_bitgemm import bitgemm_cuda, bitgemm_reference
    from repro_torch.kernels.tc_dense_mxu import dense_mxu_tc_cuda, dense_mxu_tc_reference

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popc_per_s = POPC_PER_CLOCK_PER_SM * sms * sm_clock_hz()
    cuda = torch.device("cuda")
    x, y = _bitgemm_operands(dense["email-enron"], cuda)
    xc = x[:BITGEMM_CHUNK_ROWS]
    i, w = xc.shape
    j = y.shape[0]
    out = torch.empty(i, j, dtype=torch.int32, device="cuda")
    copies = bitgemm_cuda.padded_copies
    _time_ms(bitgemm_cuda, [(xc, y, out)], 1)
    ms = _time_ms(bitgemm_cuda, [(xc, y, out)], 10)
    check(bitgemm_cuda.padded_copies == copies, "tcim's bitgemm operands were copied")
    t0 = time.perf_counter()
    want = bitgemm_reference(xc, y)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(out, want), "bitgemm at the email-enron chunk: kernel != plain")
    del want
    library_ms, unpack_s = _int_mm_bits_ms(xc, y, out)
    # Bound: X and Y read once, C written once; I J 32W one-bit products, two
    # operations each, at the b1 MMA's rate (8 x int8's). The int8 rate and
    # the popcount unit (the earlier CUDA-core kernel's) are logged beside.
    nbytes = 4 * (i + j) * w + 4 * i * j
    ops = 2 * i * j * 32 * w
    bound = _bound_ms(nbytes, ops, B1_TENSOR_OPS_PER_S)
    int8_bound = _bound_ms(nbytes, ops, INT8_TENSOR_OPS_PER_S)
    popc_bound = _bound_ms(nbytes, i * j * w, popc_per_s)
    log(f"[dense timing] bitgemm: {ms:.6f} ms/launch at email-enron chunk 0 (I={i}, J={j}, W={w}; "
        f"{ops:.4e} ops: {i * j * 32 * w} one-bit products); bound {bound[0]:.6f} ms ({bound[1]}: "
        f"b1 tensor-core rate {B1_TENSOR_OPS_PER_S:.4e} ops/s, 8 x int8's), "
        f"{100 * bound[0] / ms:.2f}% of it; at the int8 tensor-core rate over the bit products "
        f"{int8_bound[0]:.6f} ms ({int8_bound[1]}; {100 * int8_bound[0] / ms:.2f}%); at the "
        f"popcount unit (16 a clock a SM, {popc_per_s:.4e}/s) {popc_bound[0]:.6f} ms "
        f"({100 * popc_bound[0] / ms:.2f}%); plain version {plain_ms:.3f} ms (one call, same "
        f"shape); torch._int_mm on the bits as {{0,1}} int8 (product alone, J padded to 8) "
        f"{'refused' if library_ms is None else f'{library_ms:.6f} ms, == the kernel'}; "
        f"unpacking the bits took {unpack_s:.3f} s, outside that time")
    check(bound[0] <= ms, "bitgemm reads above its bound")
    row = _row("bitgemm", "src/repro_torch/kernels/csrc/tc_bitgemm.cu",
               "src/repro/kernels/tc_bitgemm.py:47",
               dense[("email-enron", "bitgemm")]["launches"], ms, plain_ms, bound, library_ms)
    rows = [row]
    del x, y, xc, out

    for name in ("email-enron", "ego-facebook"):
        g = dense[name]
        label = "dense_mxu_tc" if name == "email-enron" else f"dense_mxu_tc[n={g.n}]"
        a = _dense_upper(g, cuda)
        n = g.n
        check(not bool(torch.tril(a).any()), f"{name}: the timing input is not strictly upper-triangular")
        acc = torch.zeros(1, dtype=torch.int64, device="cuda")
        steps = torch.zeros(1, dtype=torch.int64, device="cuda")
        dense_mxu_tc_cuda(a, acc, steps)
        planned = _planned_steps(a)
        check(int(steps) == planned, f"{name}: {int(steps)} k steps computed, the plan keeps {planned}")
        rounds = 3
        ms = _time_ms(dense_mxu_tc_cuda, [(a, acc)], rounds)
        want = dense_mxu_tc_reference(a)
        torch.cuda.synchronize()
        check(int(acc) == (rounds + 1) * int(want), f"{name} mxu timing: kernel sum != plain")
        _time_ms(dense_mxu_tc_reference, [(a,)], 1)
        plain_ms = _time_ms(dense_mxu_tc_reference, [(a,)], 1)
        library_ms = _int_mm_ms(a)
        # The function's work on a strictly upper-triangular A: the products
        # with i < k < j, N (N - 1) (N - 2) / 3 int8 operations, a sixth of the
        # dense 2 N^3 (also logged, as the earlier kernel computed all of it).
        bound = _bound_ms(n * n + 8, n * (n - 1) * (n - 2) / 3, INT8_TENSOR_OPS_PER_S)
        dense_bound = _bound_ms(n * n + 8, 2 * n**3, INT8_TENSOR_OPS_PER_S)
        nt = -(-n // 128)
        log(f"[dense timing] {label}: {ms:.6f} ms/launch at {name} (N={n}; occupancy pass, plan, "
            f"the wrapper's transpose and the kernel); {planned} of {nt ** 3} k steps of 128^3 "
            f"(== the plan); triangular bound {bound[0]:.6f} ms ({bound[1]}: N(N-1)(N-2)/3 int8 "
            f"ops at 1,979 TOP/s), {100 * bound[0] / ms:.2f}% of it; the dense 2 N^3 would "
            f"take at least {dense_bound[0]:.6f} ms ({ms / dense_bound[0]:.4f} x this kernel's "
            f"time: the blocks it skips are part of that count); plain "
            f"version {plain_ms:.6f} ms; torch._int_mm (product alone, N padded to 8) "
            f"{'refused' if library_ms is None else f'{library_ms:.6f} ms'}")
        check(bound[0] <= ms, f"{name}: the kernel reads above its bound")
        row = _row(label, "src/repro_torch/kernels/csrc/tc_dense_mxu.cu",
                   "src/repro/kernels/tc_dense_mxu.py:60", dense[(name, "mxu")]["launches"], ms,
                   plain_ms, bound, library_ms)
        row["k_steps"] = planned
        rows.append(row)
        del a, acc
    return rows


def _flash_inputs(bh: int, sq: int, sk: int, hd: int, dtype, seed: int) -> tuple:
    """Normal q, k, v on the card and arange positions, the queries at the
    end of the keys when Sq < Sk (chunked prefill)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(bh, n, hd, generator=gen, device="cuda").to(dtype) for n in (sq, sk, sk))
    start = sk - sq if sq < sk else 0
    qp = torch.arange(start, start + sq, dtype=torch.int32, device="cuda").expand(bh, sq)
    kp = torch.arange(sk, dtype=torch.int32, device="cuda").expand(bh, sk)
    return q, k, v, qp.contiguous(), kp.contiguous()


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    return torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over the whole tensor."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def _flash_plain_f32(plain, ops: tuple) -> torch.Tensor:
    """The plain version with q in float32: the same scores and the same
    weights rounded to v's type, its output left unrounded. Rounded to q's
    type it is the plain version's output."""
    return plain(ops[0].float(), *ops[1:])


def _row_rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a - b|| / ||b|| of each row (last axis) of [..., d] tensors."""
    a, b = a.float(), b.float()
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)


def _gqa_inputs(b: int, sq: int, sk: int, h: int, kh: int, hd: int, dtype, seed: int,
                positions: str = "arange") -> tuple:
    """Normal q [B, Sq, H, hd], k and v [B, Sk, KH, hd] on the card and int32
    positions [B, Sq] / [B, Sk]: arange (queries at the end of the keys when
    Sq < Sk), reversed, a random permutation of each, or every key after
    every query (rows with no visible key)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, sq, h, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, sk, kh, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    start = sk - sq if sq < sk else 0
    qp = torch.arange(start, start + sq, dtype=torch.int32, device="cuda").repeat(b, 1)
    kp = torch.arange(sk, dtype=torch.int32, device="cuda").repeat(b, 1)
    if positions == "reversed":
        qp, kp = qp.flip(1).contiguous(), kp.flip(1).contiguous()
    elif positions == "permuted":
        qp = torch.stack([r[torch.randperm(sq, generator=gen, device="cuda")] for r in qp])
        kp = torch.stack([r[torch.randperm(sk, generator=gen, device="cuda")] for r in kp])
    elif positions == "keys after queries":
        kp = kp + start + sq
    return q, k, v, qp, kp


def _flash_case(kernel, plain, ops: tuple, causal: bool, heads: int, label: str) -> tuple:
    """One kernel call held to the plain version (elementwise and by row) and
    its scored-tile count to the skip rule's. Returns (max |err|, max row
    error, tiles scored)."""
    from repro_torch.kernels.flash_attention import FLASH_TILES, flash_tiles_scored

    dtype = ops[0].dtype
    tiles = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = kernel(*ops, causal=causal, tiles=tiles)
    exact = _flash_plain_f32(lambda *a: plain(*a, causal=causal), ops)
    want = exact.to(dtype)
    torch.cuda.synchronize()
    err, row = _err(got, want), float(_row_rel(got, exact).max()) if got.numel() else 0.0
    name = str(dtype).split(".")[-1]
    check(got.dtype == dtype and _close(got, want, FLASH_TOL[name]) and row <= FLASH_ROW_TOL[name],
          f"flash {label}: max |err| {err}, max row error {row}")
    predicted = flash_tiles_scored(ops[3], ops[4], heads, *FLASH_TILES[dtype], causal=causal)
    check(int(tiles) == predicted, f"flash {label}: {int(tiles)} tiles scored, the rule says "
                                   f"{predicted}")
    return err, row, int(tiles)


def phase_flash_cases() -> tuple[dict, dict]:
    """flash_attention: kernel == plain version on the card within the
    reference's elementwise tolerances and, row by row, within
    FLASH_ROW_TOL, through both entries; tiles scored == the skip rule's.
    Returns the max |err| and the max row error by type."""
    from repro_torch.kernels.flash_attention import (
        FLASH_HEAD_DIMS,
        flash_attention_bshd_cuda,
        flash_attention_bshd_reference,
        flash_attention_cuda,
        flash_attention_reference,
    )

    errs, row_errs = {}, {}
    seed = 0
    for dtype_name in FLASH_TOL:
        dtype = getattr(torch, dtype_name)
        errs[dtype_name], row_errs[dtype_name] = 0.0, 0.0
        for hd in FLASH_HEAD_DIMS:
            hd_row = 0.0
            for bh in FLASH_BH:
                for sq, sk in FLASH_SHAPES:
                    for causal in (True, False):
                        seed += 1
                        err, row, _ = _flash_case(
                            flash_attention_cuda, flash_attention_reference,
                            _flash_inputs(bh, sq, sk, hd, dtype, seed), causal, 1,
                            f"{dtype_name} hd={hd} BH={bh} Sq={sq} Sk={sk} causal={causal}")
                        errs[dtype_name] = max(errs[dtype_name], err)
                        hd_row = max(hd_row, row)
            log(f"[flash] {dtype_name} hd={hd}: [BH, S, hd] entry, BH {list(FLASH_BH)} x (Sq, Sk) "
                f"{list(FLASH_SHAPES)} x causal / not == plain within {FLASH_TOL[dtype_name]} and "
                f"rows within {FLASH_ROW_TOL[dtype_name]}; tiles scored == the skip rule's; max "
                f"row error {hd_row:.3e}")
            for b in FLASH_GQA_B:
                for h, kh in FLASH_GQA_HEADS:
                    for sq, sk in FLASH_GQA_SHAPES:
                        for causal in (True, False):
                            seed += 1
                            err, row, _ = _flash_case(
                                flash_attention_bshd_cuda, flash_attention_bshd_reference,
                                _gqa_inputs(b, sq, sk, h, kh, hd, dtype, seed), causal, h,
                                f"{dtype_name} hd={hd} B={b} H={h} KH={kh} Sq={sq} Sk={sk} "
                                f"causal={causal}")
                            errs[dtype_name] = max(errs[dtype_name], err)
                            hd_row = max(hd_row, row)
            scored = {}
            for positions in FLASH_POSITIONS:
                seed += 1
                ops = _gqa_inputs(2, 300, 260, 9, 3, hd, dtype, seed, positions)
                err, row, scored[positions] = _flash_case(
                    flash_attention_bshd_cuda, flash_attention_bshd_reference, ops, True, 9,
                    f"{dtype_name} hd={hd} positions {positions}")
                errs[dtype_name] = max(errs[dtype_name], err)
                hd_row = max(hd_row, row)
                if positions == "keys after queries":  # no row sees a key: the mean of V
                    got = flash_attention_bshd_cuda(*ops)
                    mean = ops[2].float().mean(dim=1).repeat_interleave(3, dim=1)  # [B, H, hd]
                    tol = FLASH_TOL[dtype_name]
                    check(_close(got, mean[:, None].expand_as(got), tol),
                          f"flash {dtype_name} hd={hd}: rows with no visible key are not the "
                          f"mean of V ({_err(got, mean[:, None].expand_as(got))})")
            row_errs[dtype_name] = max(row_errs[dtype_name], hd_row)
            log(f"[flash] {dtype_name} hd={hd}: [B, S, H, hd] entry, B {list(FLASH_GQA_B)} x (H, KH) "
                f"{list(FLASH_GQA_HEADS)} x (Sq, Sk) {list(FLASH_GQA_SHAPES)} x causal / not, and "
                f"positions {list(FLASH_POSITIONS)} == plain; rows with no visible key == the mean "
                f"of V; tiles scored == the skip rule's ({json.dumps(scored)} at B 2, H 9, Sq 300, "
                f"Sk 260); max row error at this hd {hd_row:.3e}; max |err| so far "
                f"{errs[dtype_name]:.3e}")
    for hd in (48, 256):
        try:
            flash_attention_cuda(*_flash_inputs(2, 64, 64, hd, torch.bfloat16, 0))
        except ValueError as e:
            log(f"[flash] hd={hd} raised: {e}")
        else:
            raise RuntimeError(f"flash_attention_cuda took the unsupported head dim {hd}")
    return errs, row_errs


def phase_lm_serve() -> dict:
    """smollm-135m served at full width on the card through the flash
    kernel, held against the plain attention path on the same weights."""
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.model import count_params_analytical, forward_train
    from repro_torch.models.params import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    log("[lm] float32 matmuls in full float32 (allow_tf32 False for cuBLAS and cuDNN)")
    max_seq = LM_PROMPT + LM_GEN + 1
    t0 = time.perf_counter()
    sess = ServeSession(LM_ARCH, batch=LM_BATCH, max_seq=max_seq, attention_impl="flash")
    cfg = sess.cfg
    n_params = sum(t.numel() for t in tree_leaves(sess.params))
    check(n_params == count_params_analytical(cfg) == 134_515_008, f"{n_params} parameters")
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} KV heads, head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, tied embeddings; {n_params} parameters in {cfg.dtype}, random from seed 0, "
        f"in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    sess.generate(prompts[:, :64], 2)  # warm-up: library handles, kernel load

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_launches()
    tokens, stats = sess.generate(prompts, LM_GEN, keep_logits=True)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    gen = tokens[:, LM_PROMPT:]
    others = {k: v for k, v in launches.items() if k != "flash_attention" and v}
    check(launches["flash_attention"] == cfg.n_layers and not others,
          f"serve launches {launches}, expected {cfg.n_layers} flash_attention")
    check(tokens.shape == (LM_BATCH, LM_PROMPT + LM_GEN) and np.isfinite(stats["logits"]).all()
          and 0 <= gen.min() and gen.max() < cfg.vocab, "generated tokens or logits malformed")
    step_ms = 1e3 * stats["decode_s"] / (LM_GEN - 1)
    log(f"[lm] flash serve: {LM_BATCH} x {LM_PROMPT} prompt tokens, {LM_GEN} generated; "
        f"launches {launches}; prefill_s {stats['prefill_s']:.6f} "
        f"({LM_BATCH * LM_PROMPT / stats['prefill_s']:.1f} prompt tokens/s); decode_s "
        f"{stats['decode_s']:.6f} over {LM_GEN - 1} steps ({step_ms:.3f} ms a step, "
        f"{stats['decode_tok_per_s']:.1f} tokens/s); max_memory_allocated {peak} bytes "
        f"({peak - base} above the {base} held before)")

    logits_f, cache_f = sess.prefill(prompts)
    xla = ServeSession(LM_ARCH, batch=LM_BATCH, max_seq=max_seq, attention_impl="xla",
                       params=sess.params)
    _reset_launches()
    logits_x, cache_x = xla.prefill(prompts)
    check(_launches()["flash_attention"] == 0, "the xla path launched the flash kernel")
    # The same weights in float32 (xla path): where each bf16 path's rounding
    # takes it, layer by layer.
    ref = ServeSession(LM_ARCH, batch=LM_BATCH, max_seq=max_seq, attention_impl="xla",
                       dtype="float32", params=tree_map(lambda t: t.float(), sess.params))
    logits_t, cache_t = ref.prefill(prompts)
    del ref
    # In bf16 both paths round at every layer, so over 30 layers they agree
    # to bf16's noise elementwise; each is held to the other in relative norm,
    # and each one's distance from the float32 run is logged beside it.
    errs = {"prefill logits": _rel(logits_f, logits_x)}
    log(f"[lm] prefill logits: max |err| flash-xla {_err(logits_f, logits_x):.6f}, flash-f32 "
        f"{_err(logits_f, logits_t):.6f}, xla-f32 {_err(logits_x, logits_t):.6f}; relative norm "
        f"flash-xla {errs['prefill logits']:.6f}, flash-f32 {_rel(logits_f, logits_t):.6f}, "
        f"xla-f32 {_rel(logits_x, logits_t):.6f}")
    for name in ("k", "v"):
        f, x, t = cache_f[name], cache_x[name], cache_t[name]
        worst = {pair: max(_err(a[i], b[i]) for i in range(cfg.n_layers))
                 for pair, a, b in (("flash-xla", f, x), ("flash-f32", f, t), ("xla-f32", x, t))}
        rms = {pair: float((a.float() - b.float()).pow(2).mean().sqrt())
               for pair, a, b in (("flash-xla", f, x), ("flash-f32", f, t), ("xla-f32", x, t))}
        rel = [_rel(f[i], x[i]) for i in range(cfg.n_layers)]
        errs[f"cache {name}"] = max(rel)
        log(f"[lm] cache {name}: max |err| {json.dumps(worst)}; rms {json.dumps(rms)}; flash-xla "
            f"relative norm by layer {json.dumps([round(r, 6) for r in rel])}; max |value| "
            f"{float(t.float().abs().max()):.4f}")
        # Layer 0's K/V precede any attention: the two paths must agree exactly.
        check(torch.equal(f[0], x[0]), f"layer-0 cache {name} differs")
    del cache_t
    # Logits at every prompt position (forward_train), on two of the prompts.
    toks = torch.from_numpy(prompts[:2].copy()).cuda()
    with torch.inference_mode():
        every_f = forward_train(sess.params, {"tokens": toks}, cfg)[0][..., : cfg.vocab]
        every_x = forward_train(sess.params, {"tokens": toks}, xla.cfg)[0][..., : cfg.vocab]
    by_pos = _row_rel(every_f, every_x)
    errs["logits at every position"] = _rel(every_f, every_x)
    log(f"[lm] logits at all {2 * LM_PROMPT} positions of 2 prompts (forward_train): flash-xla "
        f"relative norm {errs['logits at every position']:.6f}; by position max "
        f"{float(by_pos.max()):.6f}, median {float(by_pos.median()):.6f}")
    del every_f, every_x, by_pos
    # A planted fault the bound must see: a kernel that loses keys 64..127
    # (one KV tile) in every layer.
    with _dropped_kv_tile():
        logits_b, cache_b = sess.prefill(prompts)
    bad = {"prefill logits": _rel(logits_b, logits_x),
           **{f"cache {n}": max(_rel(cache_b[n][i], cache_x[n][i]) for i in range(cfg.n_layers))
              for n in ("k", "v")}}
    check(max(bad.values()) > LM_TOL, f"a dropped KV tile passes the {LM_TOL} bound: {bad}")
    log(f"[lm] planted fault (keys 64..127 dropped in every layer's attention): flash-xla "
        f"relative norm {json.dumps(bad)}, {max(bad.values()) / LM_TOL:.1f} x the {LM_TOL} bound")
    del logits_b, cache_b
    _reset_launches()
    dec, dec_max = 0.0, 0.0
    for i in range(LM_GEN - 1):  # both paths teacher-forced on the flash session's tokens
        tok = torch.from_numpy(gen[:, i : i + 1].copy()).cuda()
        lf, cache_f = sess.decode(cache_f, tok, LM_PROMPT + i)
        lx, cache_x = xla.decode(cache_x, tok, LM_PROMPT + i)
        dec, dec_max = max(dec, _rel(lf, lx)), max(dec_max, _err(lf, lx))
    errs["decode logits"] = dec
    decode_launches = _launches()
    check(not any(decode_launches.values()), f"decode launched {decode_launches}")
    check(max(errs.values()) <= LM_TOL, f"flash vs xla relative norms {errs} > {LM_TOL}")
    log(f"[lm] flash vs xla on the same weights: relative norm {json.dumps(errs)} (bound "
        f"{LM_TOL}); decode logits max |err| {dec_max:.6f}; decode launches {decode_launches}")
    del cache_f, cache_x
    xtokens, xstats = xla.generate(prompts, LM_GEN)
    share = float((xtokens[:, LM_PROMPT:] == gen).mean())
    log(f"[lm] xla serve (plain attention, chunked above {cfg.long_context_threshold}): "
        f"prefill_s {xstats['prefill_s']:.6f}, decode_s {xstats['decode_s']:.6f} "
        f"({xstats['decode_tok_per_s']:.1f} tokens/s); greedy tokens equal to the flash "
        f"session's: {share:.4f} ({int((xtokens[:, LM_PROMPT:] == gen).sum())} of {gen.size}; "
        f"distinct tokens generated {len(np.unique(gen))})")
    del xla

    f32 = ServeSession(LM_ARCH, batch=2, max_seq=128 + 8 + 1, attention_impl="flash",
                       dtype="float32")
    f32x = ServeSession(LM_ARCH, batch=2, max_seq=128 + 8 + 1, attention_impl="xla",
                        dtype="float32", params=f32.params)
    _reset_launches()
    t32, s32 = f32.generate(prompts[:2, :128], 8, keep_logits=True)
    l32 = _launches()["flash_attention"]
    tx32, sx32 = f32x.generate(prompts[:2, :128], 8, keep_logits=True)
    err32 = float(np.abs(s32["logits"] - sx32["logits"]).max())
    check(l32 == cfg.n_layers, f"float32 run: {l32} flash launches")
    check(np.array_equal(t32, tx32) and np.allclose(s32["logits"], sx32["logits"], rtol=1e-3,
                                                    atol=1e-3),
          f"float32 flash vs xla: tokens equal {np.array_equal(t32, tx32)}, max |err| {err32}")
    log(f"[lm] float32 (batch 2, prompt 128, 8 generated): {l32} flash launches (the f32 "
        f"kernel); tokens equal to xla's; max |err| of logits {err32:.3e} (bound 1e-3)")
    del f32, f32x

    long = ServeSession(LM_ARCH, batch=1, max_seq=LM_LONG + 1, attention_impl="flash",
                        params=sess.params)
    long_prompt = rng.integers(0, cfg.vocab, (1, LM_LONG), dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_long = torch.cuda.memory_allocated()
    _reset_launches()
    _, lstats = long.generate(long_prompt, 1, keep_logits=True)
    long_launches = _launches()["flash_attention"]
    long_peak = torch.cuda.max_memory_allocated()
    longx = ServeSession(LM_ARCH, batch=1, max_seq=LM_LONG + 1, attention_impl="xla",
                         params=sess.params)
    _, lxstats = longx.generate(long_prompt, 1, keep_logits=True)
    lerr = float(np.abs(lstats["logits"] - lxstats["logits"]).max())
    lrel = _rel(torch.from_numpy(lstats["logits"]), torch.from_numpy(lxstats["logits"]))
    check(long_launches == cfg.n_layers, f"prefill_32k: {long_launches} flash launches")
    check(np.isfinite(lstats["logits"]).all() and lrel <= LM_TOL,
          f"prefill_32k flash vs xla logits: relative norm {lrel}, max |err| {lerr}")
    log(f"[lm] prefill_32k, one sequence of {LM_LONG} tokens: {long_launches} flash launches; "
        f"prefill_s {lstats['prefill_s']:.6f} (xla path {lxstats['prefill_s']:.6f}); last "
        f"logits vs xla: relative norm {lrel:.6f}, max |err| {lerr:.6f}; max_memory_allocated {long_peak} bytes "
        f"({long_peak - base_long} above the {base_long} held before)")
    return {"launches": launches["flash_attention"], "long_launches": long_launches,
            "stats": stats, "xstats": xstats, "long_s": lstats["prefill_s"],
            "long_xla_s": lxstats["prefill_s"], "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "params": sess.params, "prompts": prompts,
            "tokens": gen}


def _flash_bound(qp: torch.Tensor, kp: torch.Tensor, hd: int, heads: int,
                 kv_heads: int) -> tuple[tuple[float, str], int]:
    """Least time for the kernel's work on these inputs: 4 hd flops for each
    visible (query, key) pair of each head at the bf16 tensor rate, against
    Q and O (``heads``), K and V (``kv_heads``) and the positions read or
    written once. Returns (bound, visible pairs over all heads)."""
    b, sq = qp.shape
    sk = kp.shape[1]
    ks, _ = torch.sort(kp, dim=1)
    pairs = heads * int(torch.searchsorted(ks, qp, right=True).sum())
    nbytes = 2 * b * hd * (2 * sq * heads + 2 * sk * kv_heads) + 4 * b * (sq + sk)
    return _bound_ms(nbytes, 4 * hd * pairs, BF16_PEAK), pairs


def phase_flash_timing(lm: dict) -> list:
    """The kernel at the LM prefill's two shapes, through the model's
    [B, S, H, hd] entry with the GQA heads as they are, beside its bound, its
    plain version and scaled_dot_product_attention on the same operands;
    returns the JSON rows."""
    from repro_torch.kernels.flash_attention import (
        FLASH_TILES,
        flash_attention_bshd_cuda,
        flash_attention_bshd_reference,
        flash_tiles_scored,
    )

    kernel = lambda *a: flash_attention_bshd_cuda(*a, causal=True)  # noqa: E731
    plain = lambda *a: flash_attention_bshd_reference(*a, causal=True)  # noqa: E731
    rows = []
    cells = (("flash_attention", LM_BATCH, LM_PROMPT, lm["launches"], lm["stats"]["prefill_s"]),
             (f"flash_attention[s={LM_LONG}]", 1, LM_LONG, lm["long_launches"], lm["long_s"]))
    for label, batch, s, launches, prefill_s in cells:
        h, kh, hd = lm["heads"], lm["kv_heads"], 64
        ops = _gqa_inputs(batch, s, s, h, kh, hd, torch.bfloat16, seed=s)
        tiles = torch.zeros(1, dtype=torch.int64, device="cuda")
        got = flash_attention_bshd_cuda(*ops, causal=True, tiles=tiles)
        exact = _flash_plain_f32(plain, ops)
        want = exact.to(torch.bfloat16)
        check(torch.equal(want, plain(*ops)), f"{label}: the plain version's output differs")
        q4, k4, v4 = (t.transpose(1, 2) for t in ops[:3])  # [B, heads, S, hd] views
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=True, enable_gqa=True)
        lib = sdpa().transpose(1, 2)
        torch.cuda.synchronize()
        err, row_tol = _err(got, want), FLASH_ROW_TOL["bfloat16"]
        rows_rel = _row_rel(got, exact)
        row_err = float(rows_rel.max())
        check(_close(got, want, FLASH_TOL["bfloat16"]) and row_err <= row_tol,
              f"{label}: kernel vs plain max |err| {err}, max row error {row_err}")
        check(_close(lib, want, FLASH_TOL["bfloat16"]),
              f"{label}: scaled_dot_product_attention is not the same function here")
        nq, nk = -(-s // FLASH_TILES[torch.bfloat16][0]), -(-s // FLASH_TILES[torch.bfloat16][1])
        predicted = flash_tiles_scored(ops[3], ops[4], h, *FLASH_TILES[torch.bfloat16])
        check(int(tiles) == predicted, f"{label}: {int(tiles)} tiles scored, the rule says {predicted}")
        # A planted fault the row check must see: the second half of the rows
        # computed without keys 64..127 (one dropped KV tile).
        half, keep = s // 2, torch.ones(s, dtype=torch.bool, device="cuda")
        keep[64:128] = False
        bad = exact.clone()
        bad[:, half:] = _flash_plain_f32(plain, (ops[0][:, half:], ops[1][:, keep], ops[2][:, keep],
                                                 ops[3][:, half:], ops[4][:, keep]))
        bad_rows = _row_rel(bad[:, half:], exact[:, half:])
        bad = bad.to(torch.bfloat16)
        check(float(bad_rows.min()) > row_tol,
              f"{label}: a dropped KV tile passes the row check ({float(bad_rows.min())})")
        log(f"[flash timing] {label}: kernel vs plain max |err| {err:.3e} (elementwise bound "
            f"{FLASH_TOL['bfloat16']}), row error max {row_err:.3e} / median "
            f"{float(rows_rel.median()):.3e} (bound {row_tol}); |out| median "
            f"{float(want.float().abs().median()):.3e}; {int(tiles)} of {batch * h * nq * nk} KV "
            f"tiles scored (== the skip rule). Planted fault (rows {half}.. without keys "
            f"64..127): elementwise check {'passes' if _close(bad, want, FLASH_TOL['bfloat16']) else 'fails'}"
            f" it, its row errors min {float(bad_rows.min()):.3e} / median "
            f"{float(bad_rows.median()):.3e}, so the row check fails every faulty row")
        del got, want, exact, lib, bad, bad_rows, rows_rel
        _time_ms(kernel, [ops], 2)
        ms = _time_ms(kernel, [ops], 10 if s == LM_PROMPT else 3)
        _time_ms(plain, [ops], 1)
        plain_ms = _time_ms(plain, [ops], 2 if s == LM_PROMPT else 1)
        _time_ms(sdpa, [()], 2)
        library_ms = _time_ms(sdpa, [()], 10 if s == LM_PROMPT else 3)
        bound, pairs = _flash_bound(ops[3], ops[4], hd, h, kh)
        log(f"[flash timing] {label}: {ms:.6f} ms/launch (B={batch}, H={h}, KH={kh}, Sq=Sk={s}, "
            f"hd={hd}, bf16, causal; {pairs} visible pairs); bound {bound[0]:.6f} ms "
            f"({bound[1]}: {4 * hd * pairs:.4e} flops at 989 TFLOP/s vs bytes at 3.35 TB/s), "
            f"{100 * bound[0] / ms:.2f}% of bound; plain version {plain_ms:.6f} ms (score blocks "
            f"of at most 2^28 f32); scaled_dot_product_attention (enable_gqa) {library_ms:.6f} ms "
            f"({ms / library_ms:.2f}x this kernel's time against it); max |err| vs plain {err:.3e}; "
            f"{launches} launches x {ms:.6f} ms = {launches * ms:.3f} ms of the {1e3 * prefill_s:.3f} "
            f"ms prefill ({100 * launches * ms / (1e3 * prefill_s):.1f} %)")
        row = _row(label, "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:71", launches, ms, plain_ms, bound,
                   library_ms)
        row["max_abs_err"] = err
        row["max_row_rel_err"] = row_err
        row["tiles_scored"] = int(tiles)
        rows.append(row)
        del ops, q4, k4, v4
    return rows


def _stream_graph(name: str):
    """A config's edges as the stream phases take them: generated from its
    seed and oriented by ``build_graph`` (degree relabel, as
    ``data/graph_pipeline.load_graph`` and ``benchmarks/bench_streaming.py``
    take them), with ``n`` from the graph, not the config."""
    from repro_torch.configs import GRAPHS
    from repro_torch.graphs import build_graph

    return build_graph(_edges(GRAPHS[name]), reorder=True)


def _windows(pairs: int, chunk: int) -> int:
    """Kernel launches of one count over a device work list of ``pairs``
    pairs: its pow2 bucket in windows of ``chunk`` (none when empty)."""
    from repro_torch.core.plan import pow2_ceil

    return math.ceil(pow2_ceil(pairs) / chunk) if pairs else 0


class _BatchProbe:
    """Watches one ``apply_batch`` through its executor's bound methods, so
    the stream's own entry point runs unchanged: the before and after
    count futures, whether the before-count was still in flight on the card
    when the stores were edited (a CUDA event recorded behind it), and the
    launcher the count ran through. ``stall`` cycles of
    ``torch.cuda._sleep`` go ahead of the before-count, so that it is still
    queued when the host reaches the edit."""

    def __init__(self, ex, stall: int = 0):
        self.ex, self.futures, self.pending_at_edit = ex, [], None
        self.launcher = ex._launcher
        count, update, adopt = ex.count_async, ex.update_stores, ex.adopt_stores
        event = []

        def count_async(wl):
            if stall and not self.futures:
                torch.cuda._sleep(stall)
            self.futures.append(count(wl))
            if ex.device.type == "cuda" and len(self.futures) == 1:
                event.append(torch.cuda.Event())
                event[0].record()
            return self.futures[-1]

        def edit(fn):
            def run(*args):
                if event:
                    self.pending_at_edit = not event[0].query()
                return fn(*args)
            return run

        ex.count_async, ex.update_stores, ex.adopt_stores = count_async, edit(update), edit(adopt)

    def close(self) -> list[int]:
        for name in ("count_async", "update_stores", "adopt_stores"):
            del self.ex.__dict__[name]
        return [f.result() for f in self.futures]


def _check_before_count(state, label: str, **batch) -> None:
    """One batch on the card with its before-count held in the stream's
    queue by a stall, against the same batch on the port's CPU path (a twin
    from the stream's snapshot): both counts equal, and unequal to each
    other, the edit enqueued while the before-count was in flight, and the
    launcher kept (in place) or rebuilt over the new stores (growth)."""
    from repro_torch.core import StreamingTCState

    twin = StreamingTCState.from_snapshot(*state.snapshot_tree(), device="cpu")
    card_probe = _BatchProbe(state.executor, STREAM_STALL_CYCLES)
    cpu_probe = _BatchProbe(twin.executor)
    res = state.apply_batch(**batch)
    want = twin.apply_batch(**batch)
    got, plain = card_probe.close(), cpu_probe.close()
    ex = state.executor
    check(got == plain and got[0] != got[1],
          f"{label}: before/after counts on the card {got} != CPU path's {plain}, or equal")
    check(card_probe.pending_at_edit is True,
          f"{label}: the before-count had finished before the store edit")
    check(res.triangles == want.triangles == state.verify(), f"{label}: count after the batch")
    if res.grew:
        check(ex._launcher is not card_probe.launcher and ex.adopts > 0
              and ex._launcher._prefix[0] == ex.row_data.data_ptr()
              and ex._launcher._prefix[2] == ex.col_data.data_ptr(),
              f"{label}: growth did not rebuild the launcher over the new stores")
    else:
        check(ex._launcher is card_probe.launcher, f"{label}: an in-place edit replaced the launcher")
    log(f"[stream] {label}: {'growth (stores re-adopted, launcher rebuilt)' if res.grew else 'in-place edit (launcher kept)'}"
        f" behind a before-count held {STREAM_STALL_CYCLES} cycles: before {got[0]}, after "
        f"{got[1]} == the CPU path's {plain}; the edit was enqueued while the before-count was "
        f"in flight")


def _edit_device_ms(state, hold) -> tuple[float, int]:
    """Device ms of one steady batch's store edit (both sides' gather and
    indexed write, lanes already on the card) from a replayed CUDA graph of
    edits on copies of the stores; and the batch's lane count."""
    from repro_torch.core import update_sbf

    oriented = np.sort(hold, axis=1)
    upd = update_sbf(state._sbf, oriented, None)
    check(not upd.grew, "the timed edit is a steady batch")
    ex = state.executor
    calls = []
    lanes_total = 0
    for lanes, store in ((upd.row_lanes, ex.row_data), (upd.col_lanes, ex.col_data)):
        if not lanes.num_lanes:
            continue
        lanes_total += lanes.num_lanes
        flat = lanes.pos.astype(np.int64) * store.shape[1] + lanes.word
        idx = torch.from_numpy(flat).cuda()
        set_mask = torch.from_numpy(lanes.set_mask.view(np.int32)).cuda()
        clear_mask = torch.from_numpy(lanes.clear_mask.view(np.int32)).cuda()
        calls.append((store.clone().view(-1), idx, set_mask, clear_mask))

    def edit(words, idx, set_mask, clear_mask):
        words.index_copy_(0, idx, (words.index_select(0, idx) | set_mask) & ~clear_mask)

    if not calls:
        return 0.0, 0
    graph = _graph(edit, calls, launches=20 * len(calls))
    ms = _replay_ms(graph, launches=20)  # 20 whole edits (both sides) a replay
    del graph, calls
    return ms, lanes_total


def phase_stream() -> dict:
    """Streaming counts on the card through ``StreamingTCState`` /
    ``tcim_count_delta`` (``build="auto"``: device delta work lists, the
    fused kernel), benchmarks/bench_streaming.py's protocol at full size;
    every batch held to ``verify()``, each fraction's end to the exact
    oracle; the before-count against in-place edits and growth; compaction
    and spill on roadnet-pa. Returns the launches per batch for the
    kernels line."""
    from repro_torch.core import Executor, StreamingTCState, build_sbf, build_worklist, tcim_count
    from repro_torch.core import tcim_count_delta
    from repro_torch.core.plan import clamp_chunk_pairs
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.kernels import _build
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda

    smi = nvidia_smi_line()
    chunk = clamp_chunk_pairs(1 << 20, STREAM_SLICE_BITS // 32)
    launches_per_batch = {}
    rng = np.random.default_rng(42)  # benchmarks/bench_streaming.py's seed
    for name, fractions in STREAM_GRAPHS:
        t0 = time.perf_counter()
        g = _stream_graph(name)
        order = rng.permutation(g.m)
        log(f"[stream] {name}: |V|={g.n} |E|={g.m} generated and oriented in "
            f"{time.perf_counter() - t0:.3f} s; card {smi}")
        for frac in fractions:
            b = max(int(g.m * frac), 1)
            hold, base = g.edges[order[:b]], g.edges[order[b:]]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = StreamingTCState(base, n=g.n, slice_bits=STREAM_SLICE_BITS, build="auto")
            seed_s = time.perf_counter() - t0
            check(state.device.type == "cuda" and state._use_device_build,
                  f"{name}: the stream runs on {state.device} (device build {state._use_device_build})")
            check(state.triangles == state.verify(), f"{name}: seed count")
            if name == "email-enron" and frac == STREAM_CHECK_FRACTION:
                _check_before_count(state, f"{name} {frac:g} growth", added=hold)
                _check_before_count(state, f"{name} {frac:g} in place", removed=hold)
            else:  # the bench's warm cycle: growth, then records kept as zeros
                for kw in ({"added": hold}, {"removed": hold}):
                    res = tcim_count_delta(state, kw.get("added"), kw.get("removed"))
                    check(res.triangles == state.verify(), f"{name}: warm batch")
            ex = state.executor
            stores, adopts, libs = ex.store_upload_bytes, ex.adopts, len(_build._LIBS)
            times, splits, pairs, launches, uploads = [], [], [], [], []
            _reset_launches()
            for _ in range(STREAM_ROUNDS):
                for kw in ({"added": hold}, {"removed": hold}):
                    before = (gather_total_cuda.launches, state.index_upload_bytes,
                              ex.lane_upload_bytes, ex.store_upload_bytes)
                    t0 = time.perf_counter()
                    res = state.apply_batch(**kw)
                    times.append(time.perf_counter() - t0)
                    after = (gather_total_cuda.launches, state.index_upload_bytes,
                             ex.lane_upload_bytes, ex.store_upload_bytes)
                    launches.append(after[0] - before[0])
                    uploads.append(tuple(a - c for a, c in zip(after[1:], before[1:])))
                    splits.append(res.timings_s)
                    pairs.append((res.pairs_before, res.pairs_after))
                    want = _windows(res.pairs_before, chunk) + _windows(res.pairs_after, chunk)
                    check(launches[-1] == want,
                          f"{name} {frac:g}: {launches[-1]} launches for {want} windows")
                    check(not res.grew, f"{name} {frac:g}: a steady batch grew")
                    check(res.triangles == state.verify(), f"{name} {frac:g}: batch count")
            check(state.executor is ex and ex.adopts == adopts and ex.store_upload_bytes == stores
                  and len(_build._LIBS) == libs,
                  f"{name} {frac:g}: steady batches re-adopted, uploaded stores or built a library")
            check(state.fallbacks == 0, f"{name} {frac:g}: the 'auto' host fallback fired")
            peak = torch.cuda.max_memory_allocated()
            edit_ms, lanes = _edit_device_ms(state, hold)
            # The two recounts of the final edge set: the warm device-build
            # tcim_count, and the bench's (host build + a fresh Executor).
            edges_now = state.current_edges()
            tcim_count(edges_now, n=g.n, slice_bits=STREAM_SLICE_BITS)
            t0 = time.perf_counter()
            recount = tcim_count(edges_now, n=g.n, slice_bits=STREAM_SLICE_BITS).triangles
            device_recount_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            gh = build_graph(edges_now, n=g.n, reorder=False)
            sb = build_sbf(gh, STREAM_SLICE_BITS)
            bench = Executor(sb).count(build_worklist(gh, sb))
            bench_recount_s = time.perf_counter() - t0
            exact = triangles_intersection(gh)
            check(state.triangles == recount == bench == exact,
                  f"{name} {frac:g}: running {state.triangles}, recounts {recount} / {bench}, "
                  f"oracle {exact}")
            ms = sorted(1e3 * t for t in times)
            per_batch = sum(launches) / len(launches)
            launches_per_batch[f"{name}@{frac:g}"] = per_batch
            split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
            up = [sum(u) / len(uploads) for u in zip(*uploads)]
            log(f"[stream] {name} {frac:g} (batch {b} edges, {STREAM_ROUNDS} add/remove rounds "
                f"after the warm cycle; {smi}): {float(np.median(ms)):.3f} ms/batch median, "
                f"{ms[0]:.3f} min (host clock, apply_batch ends in the counts' readback), "
                f"{b / (ms[0] / 1e3):.0f} edges/s at the min; pairs before/after "
                f"{sorted(set(pairs))}; gather_total {per_batch:g} launches/batch; running "
                f"count {state.triangles} == verify() after every batch == oracle")
            log(f"[stream] {name} {frac:g} timings_s medians (dispatch_* and scatter are enqueue "
                f"times on the card; close waits for both counts): {json.dumps(split)}")
            log(f"[stream] {name} {frac:g}: store edit {edit_ms:.6f} ms device time for {lanes} "
                f"lanes (CUDA events over a replayed CUDA graph of edits); uploaded per batch "
                f"{up[0]:.0f} B delta-work-list indices + {up[1]:.0f} B lanes + {up[2]:.0f} B "
                f"stores; recount of the final edge set: warm device-build tcim_count "
                f"{device_recount_s:.6f} s, host build + fresh Executor {bench_recount_s:.6f} s "
                f"(delta min / device recount {ms[0] / 1e3 / device_recount_s:.3f}); seed "
                f"{seed_s:.3f} s; max_memory_allocated {peak} B")
            if name == STREAM_COMPACT_GRAPH and frac == fractions[-1]:
                _stream_compact_and_spill(state, rng)
            del state, ex
    return {"launches_per_batch": launches_per_batch}


def _stream_compact_and_spill(state, rng) -> None:
    """A remove-heavy run until the zero-record ratio passes 0.5, then
    ``compact()`` (count kept, records shrink, launcher rebuilt); then
    ``spill()`` and a batch that re-admits the stream."""
    t0 = time.perf_counter()
    removed = []
    while state.zero_record_ratio() <= 0.5:
        cur = state.current_edges()
        rm = cur[rng.choice(len(cur), len(cur) // 4, replace=False)]
        res = state.apply_batch(removed=rm)
        check(res.triangles == state.verify(), "remove-heavy batch count")
        removed.append(rm)
    ratio = state.zero_record_ratio()
    launcher, count = state.executor._launcher, state.triangles
    stats = state.compact()
    check(state.triangles == count == state.verify() and stats["records_after"] < stats["records_before"]
          and state.zero_record_ratio() == 0.0, f"compaction: {stats}, count {state.triangles}")
    check(state.executor._launcher is not launcher, "compaction kept the old launcher")
    res = state.apply_batch(added=removed[0][: len(removed[0]) // 2])
    check(res.triangles == state.verify(), "batch after compaction")
    log(f"[stream] {STREAM_COMPACT_GRAPH}: {len(removed)} remove batches of a quarter of the "
        f"edges each, zero-record ratio {ratio:.4f}; compact() {stats}, count kept "
        f"({count}), launcher rebuilt; a batch after it == verify(); {time.perf_counter() - t0:.3f} s")
    old = state.executor
    state.spill()
    check(not state.resident, "spill kept the executor")
    res = state.apply_batch(added=removed[0][len(removed[0]) // 2:])
    check(state.resident and state.executor is not old and state.executor._launcher is not None
          and res.triangles == state.verify(), "spill -> batch re-admission")
    log(f"[stream] {STREAM_COMPACT_GRAPH}: spill() then a batch re-admitted the stream (new "
        f"executor and launcher), count {res.triangles} == verify()")


def phase_stream_serve() -> None:
    """Durable stream serving on the card: two streams under a budget that
    holds one, deltas drained and left pending, the server abandoned;
    ``TCServer.restore`` on the card and on the CPU against a server that
    was never killed and the exact oracle; a root written by
    ``checkpoint()`` restored too."""
    import shutil
    import tempfile

    from repro_torch.core import build_sbf
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.launch.tc_serve import ServeConfig, TCServer

    smi = nvidia_smi_line()
    rng = np.random.default_rng(7)
    streams, footprints = [], []
    for name, keep in SERVE_STREAMS:
        g = _stream_graph(name)
        order = rng.permutation(g.m)
        cut = int(g.m * keep)
        base = g.edges[order[:cut]]
        chunks = np.array_split(g.edges[order[cut:]], SERVE_DELTAS // len(SERVE_STREAMS))
        streams.append((name, g, base, chunks))
        footprints.append(TCServer._stream_footprint(
            build_sbf(build_graph(base, n=g.n, reorder=False), STREAM_SLICE_BITS)))
    budget = max(footprints) + min(footprints) // 2
    check(max(footprints) < budget < sum(footprints), f"budget {budget} for {footprints}")
    cfg = dict(checkpoint_every=8, memory_budget_bytes=budget)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_wal_"))
    try:
        srv = TCServer(ServeConfig(wal_dir=str(work / "wal"), **cfg))
        twin = TCServer(ServeConfig(**cfg))
        t0 = time.perf_counter()
        sids = [srv.create_stream(base, n=g.n) for _, g, base, _ in streams]
        create_s = time.perf_counter() - t0
        tsids = [twin.create_stream(base, n=g.n) for _, g, base, _ in streams]
        deltas = [(k % len(streams), streams[k % len(streams)][3][k // len(streams)])
                  for k in range(SERVE_DELTAS)]
        t0 = time.perf_counter()
        for i, (k, d) in enumerate(deltas):
            srv.submit_delta(sids[k], added=d)
            twin.submit_delta(tsids[k], added=d)
            if i == SERVE_DRAINED - 1:
                out = srv.drain()
                check(len(out) == SERVE_DRAINED and all(r.status == "ok" for r in out),
                      "durable server drain")
        drain_s = time.perf_counter() - t0
        check(all(r.status == "ok" for r in twin.drain()), "uninterrupted server drain")
        live = [srv.stream_count(s) for s in sids]
        live_stats = srv.server_stats()
        for entry in srv._streams.values():
            entry.wal.snaps.wait()
        del srv  # abandoned: no close_stream, no checkpoint()
        want = {s: twin.stream_count(t) for s, t in zip(sids, tsids)}
        exact = {s: triangles_intersection(g) for s, (_, g, _, _) in zip(sids, streams)}
        check(want == exact, f"uninterrupted server {want} != oracle {exact}")
        restored = {}
        for device in ("cuda", "cpu"):
            shutil.copytree(work / "wal", work / device)
            t0 = time.perf_counter()
            srv = TCServer.restore(work / device, device=device)
            restore_s = time.perf_counter() - t0
            check([srv.stream_count(s) for s in sids] == live, f"restore on {device}: live counts")
            check(srv.pending == SERVE_DELTAS - SERVE_DRAINED, f"restore on {device}: pending")
            info = srv.restore_info
            out = srv.drain()
            check(all(r.status == "ok" for r in out), f"restored drain on {device}")
            restored[device] = ({s: srv.stream_count(s) for s in sids}, srv.server_stats())
            log(f"[stream serve] restore on {device}: {restore_s:.3f} s, {json.dumps(info)}; "
                f"drained the {len(out)} pending deltas")
            if device == "cuda":
                for s in sids:
                    check(srv._streams[s].state.verify() == want[s], "restored stream verify()")
            del srv
        card, cpu = restored["cuda"], restored["cpu"]
        check(card == cpu, f"restored on the card {card} != on the CPU {cpu}")
        stream_keys = ("streams", "streams_resident", "streams_spilled", "stream_bytes")
        tstats = twin.server_stats()
        check(card[0] == want and all(card[1][k] == tstats[k] for k in stream_keys),
              f"restored {card} != uninterrupted {want}, {tstats}")
        t0 = time.perf_counter()
        twin.checkpoint(work / "ckpt")
        ckpt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = TCServer.restore(work / "ckpt")
        again_s = time.perf_counter() - t0
        check({s: again.stream_count(t) for s, t in zip(sids, tsids)} == want and again.pending == 0,
              "restore of the checkpoint() root")
        log(f"[stream serve] two streams ({', '.join(f'{n} at {k:.0%}' for n, k in SERVE_STREAMS)}), "
            f"footprints {footprints} B, budget {budget} B; created in {create_s:.3f} s; "
            f"{SERVE_DELTAS} deltas, {SERVE_DRAINED} drained in {drain_s:.3f} s (with the twin's "
            f"submits), {SERVE_DELTAS - SERVE_DRAINED} left pending at the kill; live stats "
            f"{json.dumps({k: live_stats[k] for k in live_stats if k not in ('pool', 'fused')})}; "
            f"restored on the card == on the CPU == never-killed server {want} == oracle; "
            f"checkpoint() {ckpt_s:.3f} s and its restore {again_s:.3f} s; {smi}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _replicated_launches(pairs: int, step_pairs: int, shards: int) -> int:
    """Launches of a replicated mesh count: each step's pairs dealt across
    the shards (``shard_worklist``), one launch per shard with real pairs."""
    launches = 0
    for start in range(0, pairs, step_pairs):
        p = min(step_pairs, pairs - start)
        per = -(-p // shards)
        launches += sum(1 for s in range(shards) if p - s * per > 0)
    return launches


def _shard_partials(ex, plan) -> int:
    """Every step's per-shard partial of ``ex`` over ``plan``: the kernel
    (``gather_total_cuda``) against ``gather_total_reference`` on the same
    block and indices, exact; returns their sum."""
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda, gather_total_reference

    sched = ex.stripe_schedule(plan)
    total = 0
    for step, (_, rows, cols) in zip(sched.steps, sched.emit_compact(plan.stripes)):
        for s, n in enumerate(step.lens):
            if not n:
                continue
            row, col = ex.shard_stores(s)
            ridx = torch.from_numpy(rows[s]).to(row.device)
            cidx = torch.from_numpy(cols[s]).to(row.device)
            got = gather_total_cuda(row, col, ridx, cidx, torch.zeros(2, dtype=torch.int32,
                                                                      device=row.device))
            want = gather_total_reference(row, col, ridx, cidx)
            check(torch.equal(got, want) and int(got[1]) == 0,
                  f"shard {s} partial {got.tolist()} != plain {want.tolist()}")
            total += int(got[0])
    return total


def phase_sharded(main: dict) -> dict:
    """Sharded and resilient counts on meshes of logical shards on the card
    (see the module docstring, phase 16). Returns the launches of each
    placement's count for the kernels line."""
    import shutil
    import tempfile

    from repro_torch.configs import GRAPHS
    from repro_torch.core import (
        DeviceTopology,
        Executor,
        StreamingTCState,
        build_sbf,
        build_worklist,
        plan_execution,
        tcim_count,
    )
    from repro_torch.core.plan import clamp_chunk_pairs
    from repro_torch.distributed import (
        ResilienceConfig,
        clear_sharded_executor_cache,
        distributed_tc_count,
        make_mesh,
        pooled_sharded_2d_executor,
        pooled_sharded_executor,
        resilient_tc_count,
        resume_tc_count,
    )
    from repro_torch.distributed.tc import step_launches
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.kernels.ops import INT32_SAFE_WORDS
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda
    from repro_torch.launch.tc_serve import ServeConfig, TCServer
    from repro_torch.runtime import FailureInjector, tc_remesh_plan

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    sb, wl, single = main["sbf"], main["worklist"], main["result"].triangles
    exact = main["exact"]
    check(single == exact, f"single-device count {single} != oracle {exact}")
    chunk = clamp_chunk_pairs(1 << 20, sb.words_per_slice)
    shards = [torch.device(SHARD_DEVICE)] * 4
    mesh4 = make_mesh((4,), ("d",), devices=shards)
    mesh22 = make_mesh((2, 2), ("rows", "cols"), devices=shards)
    log(f"[sharded] {MAIN_GRAPH}: {wl.num_pairs} pairs, W={sb.words_per_slice}, step budget "
        f"{chunk} pairs; meshes of logical shards on {SHARD_DEVICE}: {mesh4}, {mesh22}; {smi}")

    ex = Executor(sb)
    ex.count(wl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(ex.count(wl) == exact, "replicated Executor count")
    warm_ms = 1e3 * (time.perf_counter() - t0)
    del ex
    log(f"[sharded] replicated Executor, warm count of the same host work list: {warm_ms:.3f} ms "
        f"wall (staging, launches and readback)")

    cases = (("replicated", mesh4, "packed"), ("sharded_cols", mesh4, "packed"),
             ("sharded_2d", mesh22, "packed"), ("sharded_2d", mesh22, "lockstep"))
    launches_by_case, plans = {}, {}
    for placement, mesh, schedule in cases:
        label = f"{placement}/{schedule}"
        clear_sharded_executor_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gather_total_cuda.launches = 0
        t0 = time.perf_counter()
        got = distributed_tc_count(sb, wl, mesh, placement=placement, max_step_pairs=chunk,
                                   schedule=schedule)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = gather_total_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        check(got == exact == single, f"{label}: {got} != oracle {exact} / single {single}")
        if placement == "replicated":
            step_pairs = min(INT32_SAFE_WORDS // sb.words_per_slice, chunk)
            want = _replicated_launches(wl.num_pairs, step_pairs, mesh.size)
            check(launches == want, f"{label}: {launches} launches for {want}")
            launches_by_case[label] = launches
            log(f"[sharded] {label} on {mesh.shape}: {got} == oracle == single-device; "
                f"{wall_ms:.3f} ms wall a count (stores placed, pairs dealt, launched, read "
                f"back); {math.ceil(wl.num_pairs / step_pairs)} steps, {launches} launches "
                f"== the dealt rows'; max_memory_allocated {peak} B; {smi}")
            continue
        # The pooled executor the entry point built, and its plan again.
        t0 = time.perf_counter()
        if placement == "sharded_cols":
            ex = pooled_sharded_executor(sb, mesh, chunk_pairs=chunk, schedule=schedule)
            plan = ex._plan(wl)
        else:
            plan = plan_execution(sb, wl, DeviceTopology(num_devices=4, platform="cuda"),
                                  placement="sharded_2d", grid=(2, 2), chunk_pairs=chunk)
            ex = pooled_sharded_2d_executor(sb, mesh, plan, chunk_pairs=chunk, schedule=schedule)
        plan_s = time.perf_counter() - t0
        sched = ex.stripe_schedule(plan)
        check(launches == step_launches(sched),
              f"{label}: {launches} launches for the schedule's {step_launches(sched)}")
        # The split, under the no-host-sync check: any sync raises.
        ex.launches = ex.index_upload_bytes = 0
        torch.cuda.synchronize()
        gather_total_cuda.launches = 0
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fut = ex.count_plan_async(plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        dispatch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = fut.result()
        close_s = time.perf_counter() - t0
        check(again == exact and gather_total_cuda.launches == ex.launches == step_launches(sched),
              f"{label}: split count {again}, launches {gather_total_cuda.launches} / "
              f"{ex.launches} / {step_launches(sched)}")
        launches_by_case[label] = launches
        plans[label] = (ex, plan)
        log(f"[sharded] {label} on {mesh.shape} ({plan.split} split, imbalance "
            f"{plan.imbalance:.4f}): {got} == oracle == single-device; {wall_ms:.3f} ms wall a "
            f"count through distributed_tc_count (vs the replicated Executor's {warm_ms:.3f}); "
            f"{sched.num_steps} steps, {launches} launches == steps x non-empty shard rows; "
            f"max_memory_allocated {peak} B; {smi}")
        log(f"[sharded] {label} split: planning {1e3 * plan_s:.3f} ms (plan_execution and the "
            f"pooled executor), staging + dispatch {1e3 * dispatch_s:.3f} ms "
            f"(count_plan_async, no host sync under set_sync_debug_mode('error')), close "
            f"{1e3 * close_s:.3f} ms (result()); index bytes uploaded {ex.index_upload_bytes} "
            f"(staged lanes {sched.staged_lanes} of {sched.total_lanes}); store blocks placed "
            f"{ex.store_upload_bytes} B")

    ex, plan = plans["sharded_2d/packed"]
    partial_sum = _shard_partials(ex, plan)
    check(partial_sum == exact, f"per-shard partials sum {partial_sum} != {exact}")
    log(f"[sharded] sharded_2d/packed: every step's per-shard partial (kernel) == "
        f"gather_total_reference on the same block and indices; their sum {partial_sum} == oracle")
    steps = ex.stripe_schedule(plan).num_steps
    clear_sharded_executor_cache()
    plans.clear()
    del ex, plan

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_resilient_"))
    try:
        fail_at = steps // 2
        want_grid = list(tc_remesh_plan((2, 2), 3).new_shape)
        cfg = ResilienceConfig(checkpoint_dir=work / "count", checkpoint_every=SHARD_CHECKPOINT_EVERY,
                               injector=FailureInjector(fail_at_steps=(fail_at,)), lose_devices=1)
        gather_total_cuda.launches = 0
        t0 = time.perf_counter()
        total, info = resilient_tc_count(sb, wl, mesh22, cfg, chunk_pairs=chunk)
        res_s = time.perf_counter() - t0
        check(total == exact and info["grid"] == want_grid and info["failures"] == 1
              and info["steps_replayed"] <= SHARD_CHECKPOINT_EVERY
              and gather_total_cuda.launches > 0,
              f"resilient count {total}, info {info}, launches {gather_total_cuda.launches}")
        log(f"[sharded] resilient_tc_count on 2 x 2, failure injected at step {fail_at} of "
            f"{steps}, one device lost: {total} == oracle in {res_s:.3f} s; grid {info['grid']} "
            f"== tc_remesh_plan((2, 2), 3); {info['steps_replayed']} step(s) replayed (<= "
            f"{SHARD_CHECKPOINT_EVERY}); {info['checkpoints']} commits; recovery "
            f"{info['recovery_s']:.3f} s; {gather_total_cuda.launches} launches; remeshes "
            f"{json.dumps(info['remeshes'])}")
        fresh = make_mesh((2, 2), ("rows", "cols"), devices=shards)
        t0 = time.perf_counter()
        total, rinfo = resume_tc_count(work / "count", fresh)
        check(total == exact, f"resume_tc_count {total} != {exact}")
        log(f"[sharded] resume_tc_count of that root onto a fresh 2 x 2 mesh: {total} == oracle "
            f"in {time.perf_counter() - t0:.3f} s, {json.dumps(rinfo)}")

        edges = _edges(GRAPHS[SHARD_E2E_GRAPH])
        g = build_graph(edges, reorder=True)
        want = triangles_intersection(g)
        gather_total_cuda.launches = 0
        t0 = time.perf_counter()
        res = tcim_count(edges, mesh=mesh22, placement="sharded_2d")
        e2e_s = time.perf_counter() - t0
        check(res.triangles == want and res.stats["placement"] == "sharded_2d"
              and res.stats["build"] == "host" and gather_total_cuda.launches > 0,
              f"{SHARD_E2E_GRAPH} tcim_count(mesh=): {res.triangles} != {want} or {res.stats}")
        log(f"[sharded] tcim_count({SHARD_E2E_GRAPH}, mesh=2 x 2, placement='sharded_2d'): "
            f"{res.triangles} == oracle in {e2e_s:.3f} s ({gather_total_cuda.launches} launches), "
            f"timings_s {json.dumps(res.timings_s)}")

        jobs, wants = [], []
        for name in SHARD_SERVE_GRAPHS:
            gs = build_graph(_edges(GRAPHS[name]), reorder=True)
            sbs = build_sbf(gs, MAIN_SLICE_BITS)
            jobs.append((sbs, build_worklist(gs, sbs)))
            wants.append(triangles_intersection(gs))
        srv = TCServer(ServeConfig(fuse=False, mesh=mesh22, shard_above_bytes=1,
                                   resilience=ResilienceConfig(work / "serve")))
        gather_total_cuda.launches = 0
        t0 = time.perf_counter()
        results = _by_id(srv.serve(jobs))
        serve_s = time.perf_counter() - t0
        check([r.count for r in results] == wants
              and all(r.status == "ok" and r.placement == "sharded_2d" for r in results)
              and srv.stats["resilient_solos"] == len(jobs) and gather_total_cuda.launches > 0,
              f"sharded serve {[(r.status, r.count, r.placement) for r in results]} != {wants}, "
              f"stats {dict(srv.stats)}")
        log(f"[sharded] TCServer(mesh=2 x 2, resilience=...) served {', '.join(SHARD_SERVE_GRAPHS)} "
            f"as resilient sharded_2d solos: {wants} == oracle in {serve_s:.3f} s "
            f"({gather_total_cuda.launches} launches)")
        del srv
    finally:
        shutil.rmtree(work, ignore_errors=True)

    g = _stream_graph(SHARD_E2E_GRAPH)
    rng = np.random.default_rng(11)
    order = rng.permutation(g.m)
    b = max(int(g.m * SHARD_STREAM_FRACTION), 1)
    hold, base = g.edges[order[:b]], g.edges[order[b:]]
    t0 = time.perf_counter()
    state = StreamingTCState(base, n=g.n, slice_bits=STREAM_SLICE_BITS, mesh=mesh22)
    check(state.triangles == state.verify(), "sharded stream seed count")
    seed_s = time.perf_counter() - t0
    batch_ms, grew = [], []
    gather_total_cuda.launches = 0
    for kw in ({"added": hold}, {"removed": hold}, {"added": hold[: b // 2]},
               {"removed": hold[: b // 4], "added": hold[b // 2:]}):
        t0 = time.perf_counter()
        res = state.apply_batch(**kw)
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        grew.append(res.grew)
        check(res.triangles == state.verify(), f"sharded stream batch {kw.keys()}")
    check(gather_total_cuda.launches > 0, "the sharded stream launched no kernel")
    log(f"[sharded] mesh= stream of {SHARD_E2E_GRAPH} ({b}-edge batches, "
        f"{SHARD_STREAM_FRACTION:.0%}): seed {seed_s:.3f} s, batches {[f'{t:.3f}' for t in batch_ms]} "
        f"ms (grew {grew}), each == verify(); {gather_total_cuda.launches} launches; "
        f"final {state.triangles}")
    del state
    clear_sharded_executor_cache()
    log(f"[sharded] phase 16 took {time.perf_counter() - t_phase:.3f} s; logical shards on one "
        f"card measure the host's planning and staging and the launch count, not scaling "
        f"across cards")
    return launches_by_case


def _sync_debug(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.cuda.set_sync_debug_mode("error")``:
    a synchronizing CUDA call inside raises (a second net beside the
    contracts, process-global, so single-threaded checks only)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def _contracts(value: str):
    """``TCIM_CONTRACTS`` set to ``value`` inside, the prior value after."""
    prior = os.environ.get("TCIM_CONTRACTS")
    os.environ["TCIM_CONTRACTS"] = value
    try:
        yield
    finally:
        if prior is None:
            os.environ.pop("TCIM_CONTRACTS", None)
        else:
            os.environ["TCIM_CONTRACTS"] = prior


def _must_trip(contract: str, fn) -> str:
    """Run a planted violation: it must raise ``ContractViolation`` naming
    ``contract``; anything else propagates."""
    from repro_torch.runtime import ContractViolation

    try:
        fn()
    except ContractViolation as e:
        check(contract in str(e), f"planted {contract}: raised {e}")
        return str(e)
    raise AssertionError(f"planted {contract} violation did not raise")


def _dispatch_ms(ex, dwl, exact: int) -> float:
    """Host ms a call of ``execute_indices_async`` over a device work
    list's resident windows: ``CONTRACT_CALLS`` calls back to back, their
    results read after the clock stops."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [ex.execute_indices_async(dwl.pair_row_pos, dwl.pair_col_pos, num_real=dwl.num_pairs)
            for _ in range(CONTRACT_CALLS)]
    ms = 1e3 * (time.perf_counter() - t0) / CONTRACT_CALLS
    check(all(f.result() == exact for f in futs), "timed dispatches' counts")
    return ms


def phase_contracts(main: dict, serve: dict) -> None:
    """The runtime contracts armed (``TCIM_CONTRACTS=1`` for this phase
    only) on the card's count paths, each also under
    ``set_sync_debug_mode("error")``; their cost off and armed; one planted
    violation a contract on CUDA tensors (module docstring, phase 17)."""
    from repro_torch.core import (
        DeviceTopology,
        Executor,
        MultiGraphExecutor,
        StreamingTCState,
        device_build_async,
        plan_execution,
        tcim_count,
    )
    from repro_torch.core import build as build_mod
    from repro_torch.core.plan import clamp_chunk_pairs
    from repro_torch.distributed import Sharded2DExecutor, make_mesh
    from repro_torch.graphs import triangles_intersection
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda
    from repro_torch.runtime import contracts_enabled, max_retrace, max_transfers
    from repro_torch.runtime.staging import stage

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    edges, exact = main["edges"], main["exact"]
    check(exact == JAX_PACKAGE_COUNT, f"oracle {exact} != the JAX package's {JAX_PACKAGE_COUNT}")
    with _contracts("1"):
        check(contracts_enabled(), "TCIM_CONTRACTS=1 did not arm the contracts")
        # The device build: max_transfers(1) and no_host_sync, with an outer
        # budget to read its one staging call.
        with max_transfers(1) as ct:
            fut = _sync_debug(device_build_async, edges, slice_bits=MAIN_SLICE_BITS)
        db = fut.result()
        check(ct.count == 1 and db.worklist.num_pairs == main["worklist"].num_pairs,
              f"armed device build: {ct.count} staging calls, {db.worklist.num_pairs} pairs")
        log(f"[contracts] {MAIN_GRAPH} device_build_async armed (max_transfers(1), "
            f"no_host_sync) and under set_sync_debug_mode('error'): {ct.count} staging call, "
            f"{db.worklist.num_pairs} pairs as the host build")

        # The main count: its dispatch armed and under the debug mode, warm
        # re-dispatches bind and build nothing, and tcim_count end to end.
        ex, dwl = Executor(db.sbf), db.worklist
        gather_total_cuda.launches = 0
        fut = _sync_debug(ex.count_async, dwl)
        check(fut.result() == exact == JAX_PACKAGE_COUNT, "armed main dispatch")
        with max_retrace(0):
            fut = _sync_debug(ex.count_async, dwl)
        check(fut.result() == exact, "armed warm re-dispatch")
        res = tcim_count(edges, slice_bits=MAIN_SLICE_BITS)
        check(res.triangles == JAX_PACKAGE_COUNT and res.stats["build"] == "device",
              f"armed tcim_count: {res.triangles} ({res.stats['build']})")
        log(f"[contracts] {MAIN_GRAPH} armed: execute_indices_async under no_host_sync and "
            f"set_sync_debug_mode('error'), a warm re-dispatch under max_retrace(0), and "
            f"tcim_count end to end: {res.triangles} == {JAX_PACKAGE_COUNT} "
            f"({gather_total_cuda.launches} launches in the two dispatches)")

        # A fused serve wave and its cached re-serve, on the serve phase's
        # small tenants: the wave's dispatch under the debug mode, the
        # re-serve at zero staging calls; then TCServer on the whole fleet.
        tenants = range(NUM_TENANTS)  # _fleet's small tenants at MAIN_SLICE_BITS
        lists = [[serve["jobs"][i] for i in tenants[k : k + CONTRACT_TENANTS]]
                 for k in range(0, len(tenants), CONTRACT_TENANTS)]
        want = [tuple(serve["exact"][i] for i in tenants[k : k + CONTRACT_TENANTS])
                for k in range(0, len(tenants), CONTRACT_TENANTS)]
        multi = MultiGraphExecutor(max_batches=len(lists))
        futs = _sync_debug(multi.count_fused_wave_async, lists)
        check([f.result() for f in futs] == want, "armed fused wave")
        with max_transfers(0) as ct:
            futs = _sync_debug(multi.count_fused_wave_async, lists)
            one = _sync_debug(multi.count_fused_async, lists[0])
        check([f.result() for f in futs] == want and one.result() == want[0]
              and ct.count == 0 and multi.hits == len(lists) + 1 and multi.misses == len(lists),
              f"armed cached re-serve: {ct.count} staging calls, stats {multi.stats()}")
        from repro_torch.launch.tc_serve import ServeConfig, TCServer

        srv = TCServer(ServeConfig(fused_max_batches=64))
        for label in ("cold", "cached re-serve"):
            _check_serve(_by_id(srv.serve(serve["jobs"])), serve["exact"], f"armed {label}")
        log(f"[contracts] fused wave of {len(lists)} batches x {CONTRACT_TENANTS} tenants armed "
            f"(no_host_sync) under set_sync_debug_mode('error'), == oracle; its cached re-serve "
            f"and count_fused_async's hit at 0 staging calls (max_transfers(0)); TCServer "
            f"armed over the {len(serve['jobs'])} requests, cold and cached, == oracle")
        del srv, multi

        # A steady stream round: the add/remove signatures seen before, so
        # the counts and the store edit run under max_retrace(0); the
        # executor's dispatches and edits also under the debug mode.
        g = _stream_graph(CONTRACT_STREAM)
        rng = np.random.default_rng(21)
        b = max(int(g.m * STREAM_CHECK_FRACTION), 1)
        order = rng.permutation(g.m)
        hold, base = g.edges[order[:b]], g.edges[order[b:]]
        state = StreamingTCState(base, n=g.n, slice_bits=STREAM_SLICE_BITS)
        for _ in range(2):
            state.apply_batch(added=hold)
            state.apply_batch(removed=hold)
        sigs = set(state._steady_sigs)
        sx = state.executor
        count, edit = sx.count_async, sx.update_stores
        sx.count_async = lambda wl: _sync_debug(count, wl)
        sx.update_stores = lambda *lanes: _sync_debug(edit, *lanes)
        gather_total_cuda.launches = 0
        r_add = state.apply_batch(added=hold)
        r_rem = state.apply_batch(removed=hold)
        del sx.__dict__["count_async"], sx.__dict__["update_stores"]
        check(not r_add.grew and not r_rem.grew and state._steady_sigs == sigs
              and r_rem.triangles == state.verify() and gather_total_cuda.launches > 0,
              f"armed steady stream round: grew {r_add.grew}/{r_rem.grew}, "
              f"{len(state._steady_sigs) - len(sigs)} new signatures")
        log(f"[contracts] {CONTRACT_STREAM} stream, a steady round of {b}-edge batches armed "
            f"(every count and the edit under max_retrace(0), no signature new) with its "
            f"dispatches and edits under set_sync_debug_mode('error'): {r_add.triangles} then "
            f"{r_rem.triangles} == verify(); {gather_total_cuda.launches} launches")

        # A 2 x 2 count_plan_async on four logical shards, armed.
        sb, wl = main["sbf"], main["worklist"]
        chunk = clamp_chunk_pairs(1 << 20, sb.words_per_slice)
        mesh22 = make_mesh((2, 2), ("rows", "cols"), devices=[torch.device(SHARD_DEVICE)] * 4)
        plan = plan_execution(sb, wl, DeviceTopology(num_devices=4, platform="cuda"),
                              placement="sharded_2d", grid=(2, 2), chunk_pairs=chunk)
        sharded = Sharded2DExecutor(sb, mesh22, plan, chunk_pairs=chunk)
        check(_sync_debug(sharded.count_plan_async, plan).result() == exact, "armed 2 x 2 count")
        with max_retrace(0):
            check(_sync_debug(sharded.count_plan_async, plan).result() == exact,
                  "armed warm 2 x 2 count")
        log(f"[contracts] 2 x 2 count_plan_async on four logical shards armed (no_host_sync) "
            f"under set_sync_debug_mode('error'), warm under max_retrace(0): == oracle")
        del sharded

        # One planted violation a contract, on CUDA tensors, at wired sites.
        def read_in_dispatch():
            stepper = ex._stepper
            ex._stepper = lambda acc: (lambda r, c: (stepper(acc)(r, c), acc.tolist()))
            try:
                ex.count_async(dwl)
            finally:
                del ex.__dict__["_stepper"]

        orient = build_mod.device_orient

        def upload_twice():
            def orient_and_upload(edges, n=None, *, reorder=True, device=None):
                stage(np.zeros(4, np.int32), ex.device)  # one staging call too many
                return orient(edges, n, reorder=reorder, device=device)

            build_mod.device_orient = orient_and_upload
            try:
                device_build_async(edges, slice_bits=MAIN_SLICE_BITS)
            finally:
                build_mod.device_orient = orient

        def adopt_on_steady_signature():
            sx.update_stores = lambda *lanes: sx.adopt_stores(state._sbf)
            state.apply_batch(added=hold)

        planted = [_must_trip("no_host_sync", read_in_dispatch),
                   _must_trip("max_transfers(1)", upload_twice),
                   _must_trip("max_retrace(0)", adopt_on_steady_signature)]
        for msg in planted:
            log(f"[contracts] planted violation raised ContractViolation: {msg}")
        del state, sx

    # The cost: host ms a dispatch of the main count's resident windows and
    # the warm main count's wall time, off and armed in alternating turns.
    windows = _windows(dwl.num_pairs, ex.chunk_pairs)
    calls = {"off": [], "armed": []}
    walls = {"off": [], "armed": []}
    for _ in range(CONTRACT_TURNS):
        for mode in ("off", "armed", "armed", "off"):
            with _contracts("1" if mode == "armed" else "0"):
                calls[mode].append(_dispatch_ms(ex, dwl, exact))
    for _ in range(CONTRACT_COUNTS):
        for mode in ("off", "armed", "armed", "off"):
            with _contracts("1" if mode == "armed" else "0"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = tcim_count(edges, slice_bits=MAIN_SLICE_BITS).triangles
                walls[mode].append(1e3 * (time.perf_counter() - t0))
                check(got == exact, f"{mode} timed count")
    med = {k: float(np.median(v)) for k, v in calls.items()}
    wmed = {k: float(np.median(v)) for k, v in walls.items()}
    log(f"[contracts] execute_indices_async over {MAIN_GRAPH}'s {windows} resident windows, host "
        f"ms a call (median of {len(calls['off'])} turns of {CONTRACT_CALLS} calls): off "
        f"{med['off']:.6f} ({med['off'] / windows:.6f} a window), armed {med['armed']:.6f} "
        f"({med['armed'] / windows:.6f} a window); armed / off {med['armed'] / med['off']:.4f}; "
        f"turns off {[round(x, 6) for x in calls['off']]}, armed "
        f"{[round(x, 6) for x in calls['armed']]}; {smi}")
    log(f"[contracts] warm tcim_count({MAIN_GRAPH}) wall ms (median of {len(walls['off'])}): off "
        f"{wmed['off']:.6f}, armed {wmed['armed']:.6f}; armed / off "
        f"{wmed['armed'] / wmed['off']:.4f}; off {[round(x, 6) for x in walls['off']]}, armed "
        f"{[round(x, 6) for x in walls['armed']]}; {smi}")
    log(f"[contracts] phase 17 took {time.perf_counter() - t_phase:.3f} s")


def _numpy_params(schema, seed: int) -> dict:
    """A parameter tree of NumPy float32 arrays shaped like ``schema``, from
    one seed (the init kinds of ``models/params.py``: ones, zeros, normal
    times the leaf's scale), for ``params_from_numpy``."""
    from repro_torch.models.params import tree_map

    rng = np.random.default_rng(seed)

    def leaf(d):
        if d.init in ("ones", "zeros"):
            return (np.ones if d.init == "ones" else np.zeros)(d.shape, np.float32)
        return (d.scale * rng.standard_normal(d.shape, dtype=np.float32)).astype(np.float32)

    return tree_map(leaf, schema)


def _grads(params, batch: dict, cfg, device) -> tuple:
    """(loss, [gradient leaves]) of ``loss_fn`` on ``batch`` (NumPy) there."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.params import tree_leaves

    loss, _, grads = loss_and_grads(
        params, {k: torch.from_numpy(v).to(device) for k, v in batch.items()}, cfg)
    return loss, tree_leaves(grads)


def _leaf_names(tree) -> list[str]:
    if isinstance(tree, dict):
        return [f"{k}/{n}" if n else k for k in sorted(tree) for n in _leaf_names(tree[k])]
    return [""]


def _train_grads() -> None:
    """Card against the port's CPU path: smollm-135m at full width in
    float32, the same parameters from one seed, loss and every gradient leaf
    under each remat mode."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.model import model_schema
    from repro_torch.models.params import params_from_numpy

    cfg = get_config(TRAIN_ARCH).scaled(dtype="float32")
    tree = _numpy_params(model_schema(cfg), seed=0)
    names = _leaf_names(tree)
    b, s = TRAIN_GRAD_SHAPE
    batch = SyntheticLMDataset(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0).batch(0)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = _grads(params_from_numpy(tree, cfg, "cpu"), batch,
                                          cfg.scaled(remat="none"), "cpu")
    cpu_s = time.perf_counter() - t0
    params = params_from_numpy(tree, cfg, "cuda")
    card = {}
    _reset_launches()
    for remat in TRAIN_REMATS:
        loss, grads = _grads(params, batch, cfg.scaled(remat=remat), "cuda")
        torch.cuda.synchronize()
        loss_err = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
        errs = [_rel(g.cpu(), w) for g, w in zip(grads, cpu_grads)]
        worst = int(np.argmax(errs))
        check(all(g.is_cuda for g in grads) and loss_err <= TRAIN_LOSS_TOL
              and errs[worst] <= TRAIN_GRAD_TOL,
              f"[train] remat {remat}: loss {float(loss)} vs CPU {float(cpu_loss)} "
              f"({loss_err:.3e}), gradient {names[worst]} {errs[worst]:.3e}")
        card[remat] = grads
        log(f"[train] gradients, remat {remat!r}, card vs CPU (float32, {b} x {s}, TF32 off): "
            f"loss {float(loss):.7f} vs {float(cpu_loss):.7f} (relative {loss_err:.3e} <= "
            f"{TRAIN_LOSS_TOL}); {len(grads)} leaves, worst {names[worst]} {errs[worst]:.3e} "
            f"relative L2 (<= {TRAIN_GRAD_TOL}); median {float(np.median(errs)):.3e}")
    check(not any(_launches().values()), f"the gradient runs launched {_launches()}")
    cross = max(_rel(g, w) for r in TRAIN_REMATS[1:] for g, w in zip(card[r], card["none"]))
    equal = sum(torch.equal(g, w) for r in TRAIN_REMATS[1:] for g, w in zip(card[r], card["none"]))
    check(cross <= 1e-6, f"[train] remat modes differ on the card by {cross:.3e}")
    log(f"[train] remat modes on the card: {equal} of {2 * len(names)} leaves bit-equal to "
        f"'none', the largest difference {cross:.3e} relative L2 (the embedding's scatter-add "
        f"is atomic; equality under deterministic algorithms is the child's check); the CPU "
        f"path took {cpu_s:.2f} s")


def _train_microbatches() -> None:
    """``make_train_step(microbatches=4)`` against 1 on the card, float32:
    the moments after one update (0.1 x the clipped gradient, and its
    square) and the metrics."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import model_schema
    from repro_torch.models.params import params_from_numpy, tree_leaves
    from repro_torch.optim import adamw_init

    cfg = get_config(TRAIN_ARCH).scaled(dtype="float32")
    tree = _numpy_params(model_schema(cfg), seed=1)
    b, s = TRAIN_MICRO_SHAPE
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=1).batch(0).items()}
    params = params_from_numpy(tree, cfg, "cuda")
    runs = {}
    for n in (1, TRAIN_MICROBATCHES):
        step = make_train_step(cfg, schedule={"warmup": 0}, microbatches=n)
        runs[n] = step(params, adamw_init(params), batch)
    (_, s1, m1), (_, sn, mn) = runs[1], runs[TRAIN_MICROBATCHES]
    metric_err = max(abs(float(mn[k]) - float(m1[k])) / max(abs(float(m1[k])), 1e-30) for k in m1)
    errs = [_rel(g, w) for part in ("m", "v")
            for g, w in zip(tree_leaves(sn[part]), tree_leaves(s1[part]))]
    check(max(errs) <= TRAIN_MICRO_TOL and metric_err <= TRAIN_MICRO_TOL,
          f"[train] microbatches {TRAIN_MICROBATCHES} vs 1: moments {max(errs):.3e}, "
          f"metrics {metric_err:.3e}")
    log(f"[train] microbatches {TRAIN_MICROBATCHES} vs 1 on the card (float32, {b} x {s}): "
        f"loss {float(mn['loss']):.7f} vs {float(m1['loss']):.7f}, grad_norm "
        f"{float(mn['grad_norm']):.6f} vs {float(m1['grad_norm']):.6f}; moments worst "
        f"{max(errs):.3e} relative L2 (<= {TRAIN_MICRO_TOL}), metrics {metric_err:.3e}")


def _step_flops(cfg, n_params: int, b: int, s: int) -> tuple[float, float]:
    """(model FLOPs of one step, the products the step runs with remat
    "full"). Model FLOPs: 6 N T for the products with the weights (the tied
    embedding counted once, as the LM head) and 12 L B S^2 H hd for
    attention's scores and values (the plain path computes every S^2 score).
    The products run: 6 N_p T, N_p the product weights (the norms' scales in
    N are none), the same 12 L B S^2 H hd, and remat "full"'s second forward
    of each layer, 2 N_r T + 4 L B S^2 H hd, where N_r leaves out the MLP's
    output projection: non-reentrant ``torch.utils.checkpoint`` stops
    recomputing once the last tensor the backward saved is rebuilt, and no
    backward saves that product's output."""
    from repro_torch.models.model import model_schema
    from repro_torch.models.params import tree_leaves

    tokens = b * s
    attn = cfg.n_layers * b * s * s * cfg.n_heads * cfg.resolved_head_dim
    schema = model_schema(cfg)
    layer_products = sum(math.prod(d.shape) for d in tree_leaves(schema["layers"])
                         if len(d.shape) == 3)
    products = math.prod(schema["tok_embed"].shape) + layer_products
    recomputed = layer_products - math.prod(schema["layers"]["mlp"]["wo"].shape)
    model = 6 * n_params * tokens + 12 * attn
    return model, 6 * products * tokens + 16 * attn + 2 * recomputed * tokens


def _profile_train_step(loop, params, opt_state, tag: str = "[train]") -> None:
    """One step under ``torch.profiler``: the device's busy share of the
    step's wall and its device time by torch op."""
    from torch.profiler import ProfilerActivity, profile

    batch = {k: torch.from_numpy(v).cuda() for k, v in loop.ds.batch(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, metrics = loop.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(np.isfinite(float(metrics["loss"])), "profiled step's loss")
    busy = sum(end - start for start, end in _device_intervals(prof.events()))
    if busy == 0:
        log(f"{tag} profiled step: the profiler recorded no device activity; the device's "
            "busy share is not measured")
        return
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in ops)
    log(f"{tag} profiled step (torch.profiler, CPU + CUDA): {wall:.6f} s wall under the "
        f"profiler, device busy {busy / 1e6:.6f} s = {100 * busy / (1e6 * wall):.2f} % of it; "
        f"{total / 1e3:.3f} ms of device time in aten ops")
    for e in ops[:15]:
        log(f"{tag}   {e.key}: {e.self_device_time_total / 1e3:.3f} ms on the device "
            f"({100 * e.self_device_time_total / total:.2f} %), {e.count} calls")


def _train_full_width() -> dict:
    """``TrainLoop`` on smollm-135m at full width: bf16 parameters, float32
    moments, remat "full", 8 x 2048 tokens a step on the synthetic stream."""
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.params import tree_leaves

    smi = nvidia_smi_line()
    loop = TrainLoop(TRAIN_ARCH, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ, schedule=TRAIN_SCHEDULE)
    cfg = loop.cfg
    check(cfg.dtype == "bfloat16" and cfg.remat == "full" and cfg.attention_impl == "xla"
          and loop.device.type == "cuda", f"[train] config {cfg}")
    times: list[float] = []
    step_losses: list[float] = []
    step_fn = loop.step_fn

    def timed(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_losses.append(float(out[2]["loss"]))  # after the timing: phase 20's reference
        return out

    loop.step_fn = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    params, opt_state, flags = loop.run(TRAIN_STEPS, log_every=5)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    loop.step_fn = step_fn
    losses = [m["loss"] for m in loop.metrics_log]
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(not any(launches.values()), f"[train] the train path launched {launches}")
    check(all(np.isfinite(x) for x in losses) and losses[0] - losses[-1] >= TRAIN_MIN_DROP,
          f"[train] loss {losses} did not fall by {TRAIN_MIN_DROP}")
    check(all(t.is_cuda and t.dtype == torch.bfloat16 for t in tree_leaves(params))
          and all(t.dtype == torch.float32 for t in tree_leaves(opt_state["m"]))
          and int(opt_state["step"]) == TRAIN_STEPS, "[train] state after the run")
    med = float(np.median(times[TRAIN_WARM:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model, with_remat = _step_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    log(f"[train] TrainLoop({TRAIN_ARCH!r}) on the card: {cfg.n_layers} layers, {n_params} "
        f"parameters in {cfg.dtype}, float32 moments, remat {cfg.remat!r}, attention "
        f"{cfg.attention_impl!r}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, schedule "
        f"{TRAIN_SCHEDULE} at lr {loop.opt_cfg.lr}; {TRAIN_STEPS} steps in {wall:.3f} s "
        f"(straggler flags {flags}); loss at steps "
        f"{[(m['step'], round(m['loss'], 4)) for m in loop.metrics_log]}; fell by "
        f"{losses[0] - losses[-1]:.4f} (>= {TRAIN_MIN_DROP}); kernel launches {launches}")
    log(f"[train] synchronised step: median {1e3 * med:.3f} ms over steps {TRAIN_WARM + 1}-"
        f"{TRAIN_STEPS} (min {1e3 * min(times[TRAIN_WARM:]):.3f}, max "
        f"{1e3 * max(times[TRAIN_WARM:]):.3f}; first {1e3 * times[0]:.3f}); {tokens / med:.1f} "
        f"tokens/s; model FLOPs {model:.6e} a step = {100 * model / (med * BF16_PEAK):.2f} % of "
        f"{BF16_PEAK:.3e} FLOP/s bf16, {100 * with_remat / (med * BF16_PEAK):.2f} % counting "
        f"the products run, remat's second forward included ({with_remat:.6e}); max_memory_allocated {peak} bytes; {smi}")
    _profile_train_step(loop, params, opt_state)
    return {"losses": step_losses, "ms": 1e3 * med, "peak": peak}


def _train_resume_child() -> int:
    """The child process (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, deterministic
    algorithms): bit-equal gradients under the three remat modes at full
    width, then an uninterrupted run against one with two injected failures
    under ``run_with_auto_resume``, at a cut depth. Prints one JSON line."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.train import TrainLoop, run_with_auto_resume
    from repro_torch.models.model import model_schema
    from repro_torch.models.params import params_from_numpy, tree_leaves
    from repro_torch.runtime import FailureInjector

    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8", "CUBLAS_WORKSPACE_CONFIG")
    torch.use_deterministic_algorithms(True)
    cfg = get_config(TRAIN_ARCH).scaled(dtype="float32")
    params = params_from_numpy(_numpy_params(model_schema(cfg), seed=0), cfg, "cuda")
    b, s = TRAIN_GRAD_SHAPE
    batch = SyntheticLMDataset(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=0).batch(0)
    grads = {r: _grads(params, batch, cfg.scaled(remat=r), "cuda")
             for r in TRAIN_REMATS}
    remat_equal = all(torch.equal(grads[r][0], grads["none"][0])
                      and all(torch.equal(g, w) for g, w in zip(grads[r][1], grads["none"][1]))
                      for r in TRAIN_REMATS)
    del params, grads

    cut = get_config(TRAIN_ARCH).scaled(n_layers=RESUME_LAYERS)
    b, s = RESUME_SHAPE
    common = dict(global_batch=b, seq=s, schedule=TRAIN_SCHEDULE, ckpt_every=RESUME_EVERY,
                  cfg_override=cut)
    loop_a = TrainLoop(TRAIN_ARCH, **common)
    t0 = time.perf_counter()
    pa, sa, _ = loop_a.run(RESUME_STEPS, log_every=1)
    plain_s = time.perf_counter() - t0
    want = {m["step"]: m["loss"] for m in loop_a.metrics_log}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        loop_b = TrainLoop(TRAIN_ARCH, ckpt_dir=str(work), **common)
        t0 = time.perf_counter()
        (pb, sb, _), restarts = run_with_auto_resume(
            loop_b, RESUME_STEPS, FailureInjector(fail_at_steps=RESUME_FAIL_AT))
        resumed_s = time.perf_counter() - t0
        latest = loop_b.ckpt.latest_step()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    logged = [(m["step"], m["loss"]) for m in loop_b.metrics_log]
    state_equal = all(torch.equal(x, y) for x, y in zip(
        tree_leaves({"p": pa, "s": sa}), tree_leaves({"p": pb, "s": sb})))
    print(json.dumps({
        "remat_equal": remat_equal, "restarts": restarts, "latest": latest,
        "logged": logged, "uninterrupted": sorted(want.items()),
        "losses_equal": all(loss == want[step] for step, loss in logged),
        "state_equal": state_equal, "plain_s": plain_s, "resumed_s": resumed_s,
    }), flush=True)
    return 0


def _train_resume() -> None:
    """Run ``_train_resume_child`` in a child process and check what it read."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), RESUME_FLAG], env=env,
                          capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and bool(lines),
          f"[train] resume child exited {proc.returncode}: {proc.stdout[-4000:]}"
          f"{proc.stderr[-4000:]}")
    res = json.loads(lines[-1])
    check(res["remat_equal"], "[train] remat modes' gradients differ under deterministic algorithms")
    # Logged: step 1, every RESUME_EVERY-th, and each restart's first step,
    # the one after the checkpoint committed before its failure.
    restarted = [f // RESUME_EVERY * RESUME_EVERY + 1 for f in RESUME_FAIL_AT]
    steps = sorted([1, *range(RESUME_EVERY, RESUME_STEPS + 1, RESUME_EVERY), *restarted])
    check(res["restarts"] == len(RESUME_FAIL_AT) and res["losses_equal"] and res["state_equal"]
          and res["latest"] == RESUME_STEPS and [st for st, _ in res["logged"]] == steps,
          f"[train] resume: {res['restarts']} restarts, logged {res['logged']} vs "
          f"{res['uninterrupted']}, state equal {res['state_equal']}")
    log(f"[train] deterministic child (CUBLAS_WORKSPACE_CONFIG=:4096:8, "
        f"use_deterministic_algorithms): remat none/full/dots gradients bit-equal at full width; "
        f"resume at {RESUME_LAYERS} layers (full width otherwise, bf16, remat 'full', "
        f"{RESUME_SHAPE[0]} x {RESUME_SHAPE[1]}), {RESUME_STEPS} steps, ckpt_every {RESUME_EVERY}, "
        f"failures at steps {RESUME_FAIL_AT}: {res['restarts']} restarts, every logged loss "
        f"{res['logged']} equal to the uninterrupted run's, final params and moments bit-equal; "
        f"uninterrupted {res['plain_s']:.3f} s, with the restarts {res['resumed_s']:.3f} s; "
        f"the child took {child_s:.1f} s")


def phase_train() -> dict:
    """18: LM training on the card (see the module docstring). Returns the
    full-width run's losses a step, ms a step and peak memory (phase 20's
    one-device reference)."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    _train_grads()
    _train_microbatches()
    one_device = _train_full_width()  # its deterministic child runs in phase 18c
    log(f"[train] phase 18 took {time.perf_counter() - t_phase:.3f} s")
    return one_device


# ---------------------------------------------------------------- phase 18b


def _counted_paths(cfg, n_params: int) -> dict:
    """``step_cost`` of the three timed LM paths at the exact shapes phases 12
    and 18 timed, on meta tensors (nothing allocated): smollm's train step
    (8 x 2,048, bf16, remat "full", attention "xla"), its flash prefill (8 x
    4,096 into a fresh cache of phase 12's max_seq) and one decode step at 8
    rows with its greedy pick."""
    from repro_torch.analysis.hlo_cost import step_cost
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.specs import META, CellSpec, batch_struct
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.models.model import cache_zeros

    tags = {"attn": "attn_core"}
    spec = CellSpec(LM_ARCH, "train_4k")
    params = spec.params_struct()
    flash = cfg.scaled(attention_impl="flash")
    max_seq = LM_PROMPT + LM_GEN + 1
    prefill, decode = make_prefill_step(flash), make_serve_step(flash)
    train_batch = batch_struct(cfg, Shape("train", "train", TRAIN_SEQ, TRAIN_BATCH), True)
    prompts = {"tokens": torch.empty(LM_BATCH, LM_PROMPT, dtype=torch.int32, device=META)}
    token = torch.empty(LM_BATCH, 1, dtype=torch.int32, device=META)

    def decode_and_pick(cache):
        logits, _ = decode(params, cache, token, LM_PROMPT)
        return torch.argmax(logits, dim=-1)

    return {
        "train step": step_cost(make_train_step(cfg), params, spec.opt_struct(), train_batch,
                                tags=tags),
        "prefill": step_cost(lambda: prefill(params, cache_zeros(flash, LM_BATCH, max_seq, META),
                                             prompts), tags=tags),
        "decode step": step_cost(decode_and_pick, cache_zeros(flash, LM_BATCH, max_seq, META),
                                 tags=tags),
    }


def _reported_on_card() -> None:
    """The kernel wrappers' cost reports on CUDA tensors: one
    ``gather_total`` launch (1,000 pairs of 2 words) and one flash launch
    (2 x 200, 4 heads over 2 KV heads, hd 64), each counted once with its
    analytic FLOPs and bytes."""
    from repro_torch.analysis.hlo_cost import step_cost
    from repro_torch.kernels.flash_attention import flash_attention_bshd, flash_launch_cost
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda, modeled_hbm_bytes

    rng = np.random.default_rng(5)
    row, col = _words(rng, 500, 2), _words(rng, 300, 2)
    ridx = torch.from_numpy(rng.integers(0, 500, 1000).astype(np.int32)).cuda()
    cidx = torch.from_numpy(rng.integers(0, 300, 1000).astype(np.int32)).cuda()
    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    gather = step_cost(gather_total_cuda, row, col, ridx, cidx, out)
    check(gather.custom_calls == 1 and gather.flops == 3 * 1000 * 2
          and gather.bytes == modeled_hbm_bytes(1000, 2, fused=True),
          f"[cost] gather_total's report on the card: {gather}")
    q = torch.randn(2, 200, 4, 64, device="cuda", dtype=torch.bfloat16)
    kv = torch.randn(2, 200, 2, 64, device="cuda", dtype=torch.bfloat16)
    pos = torch.arange(200, device="cuda", dtype=torch.int32).expand(2, 200).contiguous()
    with torch.inference_mode():
        flash = step_cost(flash_attention_bshd, q, kv, kv, pos, pos)
    flops, nbytes = flash_launch_cost(2, 4, 2, 200, 200, 64, 2, True)
    check(flash.custom_calls == 1 and flash.matmul_flops == flops and flash.bytes >= nbytes,
          f"[cost] flash's report on the card: {flash}")
    torch.cuda.synchronize()
    log(f"[cost] reports on the card: gather_total {gather.flops:.0f} ops, {gather.bytes:.0f} "
        f"bytes; flash {flash.matmul_flops:.0f} FLOPs, {flash.bytes:.0f} bytes (analytic "
        f"{nbytes})")


def phase_cost(lm: dict, one_device: dict) -> dict:
    """18b: the counted cost of smollm-135m's train step, prefill and decode
    step (``analysis/hlo_cost.py::step_cost`` on meta tensors) and its
    roofline over the H100's constants, beside the times phases 12 and 18
    read; runs no new timed workload. Returns each path's numbers."""
    from repro_torch.analysis.roofline import model_flops, roofline_terms
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    _reported_on_card()
    cfg = get_config(LM_ARCH)
    check(LM_ARCH == TRAIN_ARCH and cfg.dtype == "bfloat16" and cfg.remat == "full"
          and cfg.attention_impl == "xla", f"[cost] config {cfg}")
    n_params = 134_515_008  # phase 12's count_params_analytical check
    counted = _counted_paths(cfg, n_params)
    step_model, step_products = _step_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    train = counted["train step"]
    gap = train.matmul_flops / step_products - 1
    log(f"[cost] train step's counted matmul FLOPs {train.matmul_flops:.6e} against "
        f"_step_flops's products with remat {step_products:.6e}: {100 * gap:+.4f} % "
        f"(bound {100 * COST_MATMUL_TOL:.0f} %)")
    check(abs(gap) <= COST_MATMUL_TOL, f"[cost] counted matmul FLOPs {train.matmul_flops:.6e} "
          f"vs {step_products:.6e}")
    check(counted["prefill"].custom_calls == cfg.n_layers,
          f"[cost] prefill reported {counted['prefill'].custom_calls} flash launches")
    measured = {"train step": one_device["ms"] / 1e3, "prefill": lm["stats"]["prefill_s"],
                "decode step": lm["stats"]["decode_s"] / (LM_GEN - 1)}
    kinds = {"train step": ("train", TRAIN_BATCH * TRAIN_SEQ), "prefill": ("prefill",
             LM_BATCH * LM_PROMPT), "decode step": ("decode", LM_BATCH)}
    out = {}
    for path, cost in counted.items():
        rl = roofline_terms(cost.flops, cost.bytes, cost.collective_bytes)
        share = rl["step_lower_bound_s"] / measured[path]
        kind, tokens = kinds[path]
        out[path] = {"flops": cost.flops, "matmul_flops": cost.matmul_flops, "bytes": cost.bytes,
                     "attn_bytes": (cost.bytes_by_tag or {}).get("attn", 0.0),
                     "custom_calls": cost.custom_calls, "compute_s": rl["compute_s"],
                     "memory_s": rl["memory_s"], "dominant": rl["dominant"],
                     "bound_s": rl["step_lower_bound_s"], "measured_s": measured[path],
                     "share": share, "model_flops": model_flops(kind, n_params, tokens)}
        log(f"[cost] {path}: counted {cost.flops:.6e} FLOPs ({cost.matmul_flops:.6e} in "
            f"products), {cost.bytes:.6e} bytes (eager, unfused), attn_core "
            f"{out[path]['attn_bytes']:.6e} bytes, {cost.custom_calls} kernel launches reported; "
            f"compute {1e3 * rl['compute_s']:.6f} ms, memory {1e3 * rl['memory_s']:.6f} ms, "
            f"bound {1e3 * rl['step_lower_bound_s']:.6f} ms ({rl['dominant']}); measured "
            f"{1e3 * measured[path]:.6f} ms, share {100 * share:.2f} %; model_flops "
            f"{out[path]['model_flops']:.6e}; {smi}")
        check(share <= 1.0, f"[cost] {path}: bound {rl['step_lower_bound_s']} s exceeds the "
              f"measured {measured[path]} s")
    log(f"[cost] train step's model FLOPs: model_flops (6 N D) {out['train step']['model_flops']:.6e}, "
        f"_step_flops (6 N D + 12 L B S^2 H hd) {step_model:.6e}")
    log(f"[cost] phase 18b took {time.perf_counter() - t_phase:.3f} s")
    return out


# --------------------------------------------------------------- phase 18c


def _host_available_bytes() -> int:
    """MemAvailable of this host, as /proc/meminfo reports it."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return 1024 * int(line.split()[1])
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def _leaf_rel(card: torch.Tensor, host: torch.Tensor) -> float:
    """||card - host|| / ||host|| of one leaf, on the card in float32 (the
    VLM's stacked leaves are gigabytes; float64 copies would not fit)."""
    want = host.to(card.device, torch.float32)
    diff = float((card.float() - want).norm())
    scale = float(want.norm())
    return diff / scale if scale else diff


def _metric_rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else abs(got)


def _family_train_grads(smi: str, archs) -> None:
    """18c (1): each family at full width in float32, remat "full", one
    parameter draw on the card copied to the host: ``loss_and_grads`` on the
    card against the port's CPU path at TRAIN_GRAD_SHAPE, the loss within
    TRAIN_LOSS_TOL, every metric (the MoE's router losses and dropped
    fraction) and every gradient leaf within FAMILY_CARD_TOL; the MoE also
    under remat "dots" against the same CPU gradients."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_leaves, tree_map

    b, s = TRAIN_GRAD_SHAPE
    for arch in archs:
        i = FAMILY_TRAIN_GRADS.index(arch)
        depth = FAMILY_F32_DEPTH.get(arch, 2)
        cfg = get_config(arch).scaled(n_layers=depth, dtype="float32", remat="full",
                                      attention_impl="xla")
        gc.collect()
        torch.cuda.empty_cache()
        card = init_model(torch.Generator(device="cuda").manual_seed(20 + i), cfg, "cuda")
        _open_gates(card)
        n_params = sum(t.numel() for t in tree_leaves(card))
        need, avail = 8 * n_params, _host_available_bytes()
        check(need < avail, f"[families-train] {arch}: the CPU half needs {need} bytes for "
              f"float32 parameters and gradients; the host has {avail} available")
        names = _leaf_names(card)
        batch = _family_batch(cfg, b, s, seed=30 + i)
        t0 = time.perf_counter()
        host = tree_map(lambda t: t.cpu(), card)
        loss_h, metrics_h, grads_h = loss_and_grads(host, _on(batch, "cpu"), cfg)
        cpu_s = time.perf_counter() - t0
        del host
        grads_h = tree_leaves(grads_h)
        remats = ("full", "dots") if arch == FAMILY_TRAIN_DOTS else ("full",)
        for remat in remats:
            _reset_launches()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss_c, metrics_c, grads_c = loss_and_grads(card, _on(batch, "cuda"),
                                                        cfg.scaled(remat=remat))
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            grads_c = tree_leaves(grads_c)
            check(not any(_launches().values()), f"[families-train] {arch} launched {_launches()}")
            loss_err = _metric_rel(float(loss_c), float(loss_h))
            metric_errs = {k: _metric_rel(float(metrics_c[k]), float(metrics_h[k]))
                           for k in metrics_h}
            errs = [_leaf_rel(g, w) for g, w in zip(grads_c, grads_h)]
            worst = int(np.argmax(errs))
            check(all(g.is_cuda and g.dtype == torch.float32 for g in grads_c)
                  and all(np.isfinite(float(g.float().norm())) for g in grads_c)
                  and sorted(metrics_c) == sorted(metrics_h) and loss_err <= TRAIN_LOSS_TOL
                  and max(metric_errs.values()) <= FAMILY_CARD_TOL
                  and errs[worst] <= FAMILY_CARD_TOL,
                  f"[families-train] {arch} remat {remat}: loss {float(loss_c)} vs "
                  f"{float(loss_h)} ({loss_err:.3e}), metrics {metric_errs}, gradient "
                  f"{names[worst]} {errs[worst]:.3e}")
            log(f"[families-train] {arch} ({cfg.family}{', mla' if cfg.attention == 'mla' else ''}) "
                f"float32 at full width, {depth} layers, {n_params} parameters, remat {remat!r}, "
                f"{b} x {s}, card vs CPU (TF32 off): loss {float(loss_c):.7f} vs "
                f"{float(loss_h):.7f} (relative {loss_err:.3e} <= {TRAIN_LOSS_TOL}); metrics "
                + ", ".join(f"{k} {float(metrics_c[k]):.6f} ({e:.3e})"
                            for k, e in sorted(metric_errs.items()))
                + f" (<= {FAMILY_CARD_TOL}); {len(errs)} gradient leaves, worst {names[worst]} "
                f"{errs[worst]:.3e} relative L2 (<= {FAMILY_CARD_TOL}), median "
                f"{float(np.median(errs)):.3e}; card {card_s:.3f} s, max_memory_allocated "
                f"{peak} bytes; the CPU path {cpu_s:.3f} s; {smi}")
            del grads_c
        del card, grads_h
    torch.cuda.empty_cache()


def _family_loop_cfg(arch: str, depth):
    from repro_torch.configs import get_config

    full = get_config(arch)
    return full, (full.scaled(n_layers=depth) if depth else full)


def _family_counted(cfg) -> dict:
    """``step_cost`` of one bf16 train step of ``cfg`` at the timed shape
    (FAMILY_TRAIN_BATCH x FAMILY_TRAIN_SEQ) on meta tensors, and its
    roofline over the H100's constants (device-independent: the
    "cpu-paths" host child counts them while the card's phases run)."""
    from repro_torch.analysis.hlo_cost import step_cost
    from repro_torch.analysis.roofline import roofline_terms
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.specs import batch_struct, params_struct
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    params = params_struct(cfg)
    batch = batch_struct(cfg, Shape("train", "train", FAMILY_TRAIN_SEQ, FAMILY_TRAIN_BATCH), True)
    cost = step_cost(make_train_step(cfg), params, adamw_init(params), batch,
                     tags={"attn": "attn_core"})
    rl = roofline_terms(cost.flops, cost.bytes, cost.collective_bytes)
    return {"flops": cost.flops, "matmul_flops": cost.matmul_flops, "bytes": cost.bytes,
            "attn_bytes": (cost.bytes_by_tag or {}).get("attn", 0.0),
            "compute_s": rl["compute_s"], "memory_s": rl["memory_s"],
            "bound_s": rl["step_lower_bound_s"], "dominant": rl["dominant"]}


def _card_drawn_loop(arch: str, **kwargs):
    """A ``TrainLoop`` whose fresh state is drawn on its device from seed 0
    (``init_model`` with a generator there, as phase 19 draws its weights):
    the loop's own init draws on the host, one normal at a time, which takes
    10-25 s for the 1-2.3 B parameters of a config here. Everything else is
    ``TrainLoop``'s: steps, logging, checkpoints, restores."""
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.model import init_model
    from repro_torch.optim import adamw_init

    class CardDrawn(TrainLoop):
        def init_state(self):
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = init_model(gen, self.cfg, self.device)
            return params, adamw_init(params)

    return CardDrawn(arch, **kwargs)


@contextlib.contextmanager
def _expandable_segments():
    """The card's allocator with expandable segments, for the full-width
    TrainLoops. With fixed segments a step's freed blocks (up to 5 GiB:
    moonshot's float32 logits) split the cached segments into holes that a
    later block does not fit: a step that needs 52 GiB ran out of the card
    with 36 GiB reserved and unused. Only here: a segment that grows maps
    its pages anew after each ``empty_cache``, which slowed the phases that
    place tens of GB (21d 2.6 x with it on for the whole script)."""
    settings = (getattr(torch._C, "_accelerator_setAllocatorSettings", None)
                or torch.cuda.memory._set_allocator_settings)  # the older torch's name
    gc.collect()
    torch.cuda.empty_cache()
    settings("expandable_segments:True")
    try:
        probe = torch.empty(1 << 28, device="cuda")  # 1 GiB: past what the cache holds free
        ptr = probe.data_ptr()
        home = [seg for seg in torch.cuda.memory_snapshot()
                if seg["address"] <= ptr < seg["address"] + seg["total_size"]]
        del probe
        check(len(home) == 1 and home[0].get("is_expandable", False),
              f"[families-train] the allocator put a block in a fixed segment under "
              f"expandable_segments:True ({home})")
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        settings("expandable_segments:False")


def _family_train_loop(arch: str, depth, smi: str, counted: dict) -> dict:
    """18c (2): ``TrainLoop`` of one family at full width: bf16 parameters,
    float32 moments, remat "full", FAMILY_TRAIN_BATCH x FAMILY_TRAIN_SEQ
    tokens a step (MoE: routing groups of 1,024), TRAIN_SCHEDULE."""
    from repro_torch.models.model import count_params_analytical
    from repro_torch.models.params import tree_leaves

    full, cfg = _family_loop_cfg(arch, depth)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held, cached = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    loop = _card_drawn_loop(arch, global_batch=FAMILY_TRAIN_BATCH, seq=FAMILY_TRAIN_SEQ,
                            schedule=TRAIN_SCHEDULE, cfg_override=cfg)
    check(cfg.dtype == "bfloat16" and cfg.remat == "full" and cfg.attention_impl == "xla"
          and loop.device.type == "cuda", f"[families-train] {arch} config {cfg}")
    times: list[float] = []
    losses: list[float] = []
    dropped: list[float] = []
    step_fn = loop.step_fn

    def timed(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out[2]["loss"]))
        if "moe_dropped_frac" in out[2]:
            dropped.append(float(out[2]["moe_dropped_frac"]))
        return out

    loop.step_fn = timed
    _reset_launches()
    t0 = time.perf_counter()
    params, opt_state, flags = loop.run(FAMILY_TRAIN_STEPS, log_every=10)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak, peak_reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    loop.step_fn = step_fn
    n_params = sum(t.numel() for t in tree_leaves(params))
    bar = TRAIN_MIN_DROP
    check(n_params == count_params_analytical(cfg), f"[families-train] {arch}: {n_params} "
          f"parameters, the schema counts {count_params_analytical(cfg)}")
    check(not any(launches.values()), f"[families-train] {arch} launched {launches}")
    tail = float(np.mean(losses[-FAMILY_TRAIN_TAIL:]))
    check(all(np.isfinite(x) for x in losses) and losses[0] - tail >= bar,
          f"[families-train] {arch}: loss {losses} did not fall by {bar}")
    check(all(t.is_cuda and t.dtype in (torch.bfloat16, torch.float32) for t in tree_leaves(params))
          and int(opt_state["step"]) == FAMILY_TRAIN_STEPS, f"[families-train] {arch} state")
    med = float(np.median(times[FAMILY_TRAIN_WARM:]))
    tokens = FAMILY_TRAIN_BATCH * FAMILY_TRAIN_SEQ
    cost = counted
    share = cost["bound_s"] / med
    check(share <= 1.0, f"[families-train] {arch}: bound {cost['bound_s']} s exceeds "
          f"the measured {med} s")
    drops = (f"; dropped fraction first {dropped[0]:.6f}, last {dropped[-1]:.6f}, mean "
             f"{float(np.mean(dropped)):.6f}" if dropped else "")
    log(f"[families-train] TrainLoop({arch!r}) on the card: {cfg.family}, {cfg.n_layers} of "
        f"{full.n_layers} layers, {n_params} parameters in {cfg.dtype}, float32 moments, remat "
        f"{cfg.remat!r}, attention {cfg.attention_impl!r}, {FAMILY_TRAIN_BATCH} x "
        f"{FAMILY_TRAIN_SEQ} tokens a step (no microbatches), schedule {TRAIN_SCHEDULE} "
        f"at lr {loop.opt_cfg.lr}; {FAMILY_TRAIN_STEPS} steps in {wall:.3f} s (straggler flags "
        f"{flags}); loss first {losses[0]:.4f}, last {losses[-1]:.4f}, mean of the last "
        f"{FAMILY_TRAIN_TAIL} {tail:.4f}: fell by {losses[0] - tail:.4f} (>= {bar}); logged "
        f"{[(m['step'], round(m['loss'], 4)) for m in loop.metrics_log]}{drops}; kernel "
        f"launches {launches}")
    log(f"[families-train] {arch} synchronised step: median {1e3 * med:.3f} ms over steps "
        f"{FAMILY_TRAIN_WARM + 1}-{FAMILY_TRAIN_STEPS} (min {1e3 * min(times[FAMILY_TRAIN_WARM:]):.3f}, "
        f"max {1e3 * max(times[FAMILY_TRAIN_WARM:]):.3f}; first {1e3 * times[0]:.3f}); "
        f"{tokens / med:.1f} tokens/s; max_memory_allocated {peak} bytes ({peak / n_params:.2f} "
        f"a parameter), max_memory_reserved {peak_reserved} bytes; before the loop {held} "
        f"bytes allocated and {cached} reserved; {smi}")
    log(f"[families-train] {arch} counted step (meta, eager unfused bytes, in the host "
        f"child): {cost['flops']:.6e} FLOPs "
        f"({cost['matmul_flops']:.6e} in products), {cost['bytes']:.6e} bytes, attn_core "
        f"{cost['attn_bytes']:.6e}; compute {1e3 * cost['compute_s']:.6f} ms, memory "
        f"{1e3 * cost['memory_s']:.6f} ms, bound {1e3 * cost['bound_s']:.6f} ms "
        f"({cost['dominant']}); measured {1e3 * med:.6f} ms, share {100 * share:.2f} %; {smi}")
    _profile_train_step(loop, params, opt_state, tag=f"[families-train] {arch}")
    return {"ms": 1e3 * med, "peak": peak, "params": n_params, "share": share,
            "losses": (losses[0], losses[-1], tail)}


def _family_resume_child() -> int:
    """The child process (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, deterministic
    algorithms): the MoE at full width and FAMILY_RESUME_LAYERS layers, an
    uninterrupted ``TrainLoop`` against one with injected failures under
    ``run_with_auto_resume``. Prints one JSON line."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import run_with_auto_resume
    from repro_torch.models.params import tree_leaves
    from repro_torch.runtime import FailureInjector

    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8", "CUBLAS_WORKSPACE_CONFIG")
    torch.use_deterministic_algorithms(True)
    cut = get_config(FAMILY_RESUME_ARCH).scaled(n_layers=FAMILY_RESUME_LAYERS)
    b, s = FAMILY_RESUME_SHAPE
    common = dict(global_batch=b, seq=s, schedule=TRAIN_SCHEDULE, ckpt_every=FAMILY_RESUME_EVERY,
                  cfg_override=cut)
    loop_a = _card_drawn_loop(FAMILY_RESUME_ARCH, **common)
    t0 = time.perf_counter()
    pa, sa, _ = loop_a.run(FAMILY_RESUME_STEPS, log_every=1)
    plain_s = time.perf_counter() - t0
    want = {m["step"]: (m["loss"], m["moe_dropped_frac"]) for m in loop_a.metrics_log}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_"))
    try:
        free = shutil.disk_usage(work).free
        loop_b = _card_drawn_loop(FAMILY_RESUME_ARCH, ckpt_dir=str(work), **common)
        t0 = time.perf_counter()
        (pb, sb, _), restarts = run_with_auto_resume(
            loop_b, FAMILY_RESUME_STEPS, FailureInjector(fail_at_steps=FAMILY_RESUME_FAIL_AT))
        resumed_s = time.perf_counter() - t0
        latest = loop_b.ckpt.latest_step()
        ckpt_bytes = sum(f.stat().st_size for f in work.rglob("*") if f.is_file())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    logged = [(m["step"], m["loss"], m["moe_dropped_frac"]) for m in loop_b.metrics_log]
    leaves_a = tree_leaves({"p": pa, "s": sa})
    state_equal = len(leaves_a) == len(tree_leaves({"p": pb, "s": sb})) and all(
        torch.equal(x, y) for x, y in zip(leaves_a, tree_leaves({"p": pb, "s": sb})))
    print(json.dumps({
        "restarts": restarts, "latest": latest, "logged": logged,
        "uninterrupted": sorted((k, *v) for k, v in want.items()),
        "losses_equal": all((loss, drop) == want[step] for step, loss, drop in logged),
        "state_equal": state_equal, "plain_s": plain_s, "resumed_s": resumed_s,
        "n_params": sum(t.numel() for t in tree_leaves(pa)), "disk_free": free,
        "ckpt_bytes": ckpt_bytes,
    }), flush=True)
    return 0


def _family_resume() -> None:
    """Run ``_family_resume_child`` in a child process and check what it read."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), FAMILY_RESUME_FLAG],
                          env=env, capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and bool(lines),
          f"[families-train] resume child exited {proc.returncode}: {proc.stdout[-4000:]}"
          f"{proc.stderr[-4000:]}")
    res = json.loads(lines[-1])
    every, steps_n = FAMILY_RESUME_EVERY, FAMILY_RESUME_STEPS
    # Logged under run_with_auto_resume: step 1, every 10th (TrainLoop.run's
    # default), and each restart's first, the one after the checkpoint
    # committed before its failure.
    restarted = [f // every * every + 1 for f in FAMILY_RESUME_FAIL_AT]
    steps = sorted({1, *range(10, steps_n + 1, 10), *restarted})
    check(res["restarts"] == len(FAMILY_RESUME_FAIL_AT) and res["losses_equal"]
          and res["state_equal"] and res["latest"] == steps_n
          and [st for st, *_ in res["logged"]] == steps,
          f"[families-train] MoE resume: {res['restarts']} restarts, logged {res['logged']} vs "
          f"{res['uninterrupted']}, state equal {res['state_equal']}")
    log(f"[families-train] deterministic child (CUBLAS_WORKSPACE_CONFIG=:4096:8, "
        f"use_deterministic_algorithms): {FAMILY_RESUME_ARCH} at full width, "
        f"{FAMILY_RESUME_LAYERS} layer(s), {res['n_params']} parameters, bf16, remat 'full', "
        f"{FAMILY_RESUME_SHAPE[0]} x {FAMILY_RESUME_SHAPE[1]} tokens (one routing group of "
        f"1,024), {steps_n} steps, ckpt_every {every}, failures at steps "
        f"{FAMILY_RESUME_FAIL_AT}: {res['restarts']} restart(s), every logged (step, loss, "
        f"dropped fraction) {res['logged']} equal to the uninterrupted run's, final params and "
        f"moments bit-equal; uninterrupted {res['plain_s']:.3f} s, with the restart "
        f"{res['resumed_s']:.3f} s; {res['ckpt_bytes']} bytes of checkpoints at the end "
        f"({res['disk_free']} free before); the child took {child_s:.1f} s")


def _beside(children, body) -> None:
    """Run each of ``children`` (each starts a child process and checks what
    it read) in a thread while ``body()`` runs here; then wait for them all
    and raise the first failure. No child outlives the call."""
    import threading

    failed: list = []

    def run(fn):
        try:
            fn()
        except BaseException as e:  # re-raised below, once every thread has ended
            failed.append(e)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in children]
    for t in threads:
        t.start()

    try:
        body()
    finally:
        for t in threads:
            t.join()
    if failed:
        raise failed[0]


def _host_children_done(children, tag: str) -> None:
    """Wait until every host child has exited 0 (at most LJ_CHILD_TIMEOUT
    seconds each) and log by when they had."""
    t0 = time.perf_counter()
    for proc, work, _ in children:
        rc = proc.wait(timeout=LJ_CHILD_TIMEOUT)
        if rc != 0:
            check(False, f"{tag} host child exited {rc}: {(work / 'child.log').read_text()[-4000:]}")
    log(f"{tag} host children have exited, by {time.perf_counter() - min(c[2] for c in children):.1f}"
        f" s after they started; waited {time.perf_counter() - t0:.3f} s here")


def phase_families_train(oracles: tuple, cpu_paths: tuple) -> dict:
    """18c: the LM families' training on the card (see the module
    docstring): the TrainLoops first, with their counted bounds from the
    "cpu-paths" host child; then the float32 holds of the five smaller
    configs, beside the deterministic children of phases 18, 20 and 18c;
    then, once those and both host children have exited, the vlm's hold
    alone (52 GB of the host and of the card). Returns each TrainLoop's ms
    a step, peak, parameters and share of its counted bound by config."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    costs = _child_result(cpu_paths, "costs.json", MAIN_ORACLE_TIMEOUT)
    with _expandable_segments():
        loops = {arch: _family_train_loop(arch, depth, smi, costs[arch])
                 for arch, depth in FAMILY_TRAIN_LOOPS}
    t_loops = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()  # the children need the card's memory that this process cached

    _beside((_train_resume, _sharded_resume, _family_resume),
            lambda: _family_train_grads(smi, [a for a in FAMILY_TRAIN_GRADS if a != FAMILY_VLM]))
    t_window = time.perf_counter() - t_phase - t_loops
    _host_children_done((oracles, cpu_paths), "[families-train]")
    _family_train_grads(smi, [FAMILY_VLM])
    torch.cuda.empty_cache()
    log(f"[families-train] phase 18c took {time.perf_counter() - t_phase:.3f} s (TrainLoops "
        f"{t_loops:.3f}, float32 gradients beside the deterministic children {t_window:.3f}, "
        f"the vlm's {time.perf_counter() - t_phase - t_loops - t_window:.3f})")
    return loops


# ---------------------------------------------------------------- phase 19


def _flash_fits(cfg) -> bool:
    """Whether the flash kernel takes the config's attention (equal q/k/v
    widths in FLASH_HEAD_DIMS); where it does not, impl "flash" raises."""
    from repro_torch.kernels.flash_attention import FLASH_HEAD_DIMS

    return (cfg.uses_attention and cfg.attention != "mla"
            and cfg.resolved_head_dim in FLASH_HEAD_DIMS)


def _family_batch(cfg, b: int, s: int, seed: int) -> dict:
    """tests/test_models.py's batch of a family from a NumPy seed (frames,
    mask and labels for audio; tokens, labels and vlm image embeddings)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(b, s, cfg.d_frontend)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
                "mask": rng.random((b, s)) < 0.3}
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    return batch


def _open_gates(params) -> None:
    """A vlm's cross-attention gates at ``FAMILY_GATE`` (init leaves them at
    0, where ``tanh(gate)`` mutes the image tokens), in place."""
    if "cross_layers" in params:
        params["cross_layers"]["xattn"]["gate"].fill_(FAMILY_GATE)


def _passing_conv(params) -> None:
    """An SSM or hybrid config's mamba layers with their depthwise conv taps
    passing their input (1 added to the last tap), in place. At the init's
    taps (N(0, 0.02^2)) the conv shrinks x, B and C about 30 x each, so the
    scan's recurrent term ``C·h`` is about 1e-3 of the skip ``D·x`` and a
    fault in the state (a shard reading its neighbour's heads) hides in the
    bf16 drift."""
    ssm = params.get("layers", {}).get("ssm")
    if ssm is not None:
        for k in ("conv_x", "conv_b", "conv_c"):
            ssm[k][:, -1] += 1.0


def _sharp_mla(params, cfg) -> None:
    """An MLA config's query latent norm (``q_norm``) scaled in place so
    that the latent part of the scores, ``(q_nope wuk^T)·ckv / sqrt(nope +
    rope)``, spreads about ``MLA_SCORE_STD``. At the init's weights it
    spreads about ``std(wuq) std(wuk) sqrt(q_rank nope kv_rank / (nope +
    rope))`` (0.14 at minicpm3's widths, 6e-3 at its smoke config's): every
    head attends nearly uniformly, each head's combined latent is nearly
    the prompt's mean latent, and a fault that hands a shard its
    neighbour's heads of it hides in the bf16 drift."""
    attn = params.get("layers", {}).get("attn", {})
    if "q_norm" not in attn:
        return
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    spread = (float(attn["wuq"].float().std()) * float(attn["wuk"].float().std())
              * (cfg.q_lora_rank * cfg.qk_nope_dim * cfg.kv_lora_rank / qk) ** 0.5)
    attn["q_norm"].mul_(MLA_SCORE_STD / spread)


def _on(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _teacher_forcing(params, cfg, batch: dict, decoded: int) -> tuple[float, float]:
    """Prefill all but the last ``decoded`` tokens, decode those one by one:
    (max |err|, max relative norm over the steps) of each step's logits
    against ``forward_train``'s at the same position (tests/test_models.py:70
    bounds the first at smoke width)."""
    from repro_torch.models.model import decode_step, forward_prefill, forward_train, init_cache

    tokens = batch["tokens"]
    b, s = tokens.shape
    sp = s - decoded
    with torch.inference_mode():
        full, _ = forward_train(params, batch, cfg)
        cache = init_cache(cfg, b, s, tokens.device)
        last, cache = forward_prefill(params, dict(batch, tokens=tokens[:, :sp]), cache, cfg)
        pairs = [(last, full[:, sp - 1])]
        for t in range(sp, s):
            logits, cache = decode_step(params, cache, tokens[:, t:t + 1], t, cfg)
            pairs.append((logits, full[:, t]))
    live = slice(0, cfg.vocab)  # the padded vocab's -1e30 columns are equal and left out
    return (max(_err(a[:, live], w[:, live]) for a, w in pairs),
            max(_rel(a[:, live], w[:, live]) for a, w in pairs))


def _families_smoke() -> int:
    """19a: each arch's smoke config on the card against the port's CPU path
    on the same float32 weights (forward_train logits, loss_fn and every
    gradient leaf), and decode against teacher forcing on the card in the
    config's dtype, under "xla" and, where the kernel takes the heads,
    "flash". Returns the flash launches of the teacher-forcing runs."""
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.model import forward_train, init_model
    from repro_torch.models.params import tree_leaves, tree_map

    flash = 0
    for i, arch in enumerate(ARCHS):
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        host = init_model(i, cfg, "cpu")
        _open_gates(host)
        card = tree_map(lambda t: t.cuda(), host)
        batch = _family_batch(cfg, 2, 16, seed=i)
        with torch.inference_mode():
            lc = forward_train(card, _on(batch, "cuda"), cfg)[0]
            lh = forward_train(host, _on(batch, "cpu"), cfg)[0]
        rel_logits = _rel(lc.cpu(), lh)
        loss_c, metrics_c, grads_c = loss_and_grads(card, _on(batch, "cuda"), cfg)
        loss_h, metrics_h, grads_h = loss_and_grads(host, _on(batch, "cpu"), cfg)
        grad_rel = [float((g.cpu().double() - w.double()).norm() / w.double().norm().clamp_min(1e-30))
                    for g, w in zip(tree_leaves(grads_c), tree_leaves(grads_h))]
        check(lc.is_cuda and rel_logits <= FAMILY_CARD_TOL,
              f"[families] {arch}: card vs CPU logits relative norm {rel_logits}")
        check(abs(float(loss_c) - float(loss_h)) <= FAMILY_CARD_TOL * abs(float(loss_h))
              and sorted(metrics_c) == sorted(metrics_h) and max(grad_rel) <= FAMILY_CARD_TOL,
              f"[families] {arch}: loss {float(loss_c)} vs {float(loss_h)}, gradient relative L2 "
              f"max {max(grad_rel)}")
        msg = (f"[families] {arch} ({cfg.family}{', mla' if cfg.attention == 'mla' else ''}) smoke, "
               f"float32, card vs CPU: logits relative norm {rel_logits:.3e}, loss {float(loss_c):.6f} "
               f"vs {float(loss_h):.6f}, metrics {sorted(metrics_c)}, {len(grad_rel)} gradient "
               f"leaves, relative L2 max {max(grad_rel):.3e} (bound {FAMILY_CARD_TOL})")
        if cfg.family != "audio":
            dcfg = get_smoke_config(arch)  # the config's own dtype, as tests/test_models.py runs it
            params = init_model(i + 100, dcfg, "cuda")
            _open_gates(params)
            tf_batch = _on({k: v for k, v in _family_batch(dcfg, 2, 12, seed=i + 3).items()
                            if k != "labels"}, "cuda")
            impls = ("xla", "flash") if _flash_fits(dcfg) else ("xla",)
            errs = {}
            for impl in impls:
                _reset_launches()
                errs[impl] = _teacher_forcing(params, dcfg.scaled(attention_impl=impl), tf_batch, 4)
                launched = _launches()["flash_attention"]
                check(errs[impl][0] < FAMILY_TF_TOL and (launched > 0) == (impl == "flash"),
                      f"[families] {arch} {impl}: decode vs teacher forcing max |err| "
                      f"{errs[impl][0]} (bound {FAMILY_TF_TOL}), {launched} flash launches")
                flash += launched
            msg += (f"; decode vs teacher forcing on the card ({dcfg.dtype}): "
                    + ", ".join(f"{k} max |err| {e:.3e} (relative norm {r:.3e})"
                                for k, (e, r) in errs.items()) + f" (bound {FAMILY_TF_TOL})")
        log(msg)
        del host, card, lc, lh, grads_c, grads_h
    return flash


@contextlib.contextmanager
def _moe_drops():
    """Record each MoE layer call's (sequence length, dropped fraction
    tensor) while the model runs (read after it, no host sync inside)."""
    from repro_torch.models import moe

    real, seen = moe.moe_forward, []

    def spy(p, x, cfg, group_size=1024):
        y, aux = real(p, x, cfg, group_size=group_size)
        seen.append((x.shape[1], aux["moe_dropped_frac"]))
        return y, aux

    moe.moe_forward = spy
    try:
        yield seen
    finally:
        moe.moe_forward = real


def _families_serve(smi: str) -> tuple[dict, dict]:
    """19b: the six configs at full width in bf16: ServeSession (4 x 512
    prompt tokens, 16 generated) for the decoders, forward_train on 4 x 512
    frames for the audio encoder, each under "xla" and, where the kernel
    takes the heads, "flash". Returns the flash launches by config and the
    kernel rows of FAMILY_FLASH_ROWS by config."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.model import count_params_analytical, forward_train, init_model
    from repro_torch.models.params import tree_leaves, tree_map

    flash, rows = {}, {}
    rng = np.random.default_rng(19)
    for arch, depth, impls in FAMILY_SERVE:
        full = get_config(arch)
        cfg = full.scaled(n_layers=depth) if depth else full
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
        _open_gates(params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        check(n_params == count_params_analytical(cfg), f"[families] {arch}: {n_params} parameters")
        cut = f"{depth} of {full.n_layers} layers" if depth else f"all {full.n_layers} layers"
        log(f"[families] {arch} ({cfg.family}) at full width, {cut}: {n_params} parameters in bf16 "
            f"({count_params_analytical(full)} at full depth), drawn on the card from seed 0 in "
            f"{init_s:.3f} s; {smi}")
        prompts = rng.integers(0, cfg.vocab, (FAMILY_BATCH, FAMILY_PROMPT), dtype=np.int32)
        img = None
        if cfg.family == "vlm":
            img = rng.normal(size=(FAMILY_BATCH, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
        first = {}
        for impl in impls:
            sess = ServeSession(arch, batch=FAMILY_BATCH, max_seq=FAMILY_PROMPT + FAMILY_GEN + 1,
                                attention_impl=impl, n_layers=depth, params=params)
            sess.generate(prompts[:, :64], 2, image_embeds=img)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            with _moe_drops() as drops:
                tokens, stats = sess.generate(prompts, FAMILY_GEN, image_embeds=img,
                                              keep_logits=True)
            launches = _launches()
            peak = torch.cuda.max_memory_allocated()
            gen = tokens[:, FAMILY_PROMPT:]
            want_flash = FAMILY_FLASH_LAYERS[arch] if impl == "flash" else 0
            others = {k: v for k, v in launches.items() if k != "flash_attention" and v}
            check(launches["flash_attention"] == want_flash and not others,
                  f"[families] {arch} {impl}: launches {launches}, expected {want_flash} flash")
            check(tokens.shape == (FAMILY_BATCH, FAMILY_PROMPT + FAMILY_GEN)
                  and np.isfinite(stats["logits"][..., :cfg.vocab]).all()
                  and 0 <= gen.min() and gen.max() < cfg.vocab,
                  f"[families] {arch} {impl}: generated tokens or logits malformed")
            first[impl] = torch.from_numpy(stats["logits"][0, :, :cfg.vocab])
            if impl == "flash":
                flash[arch] = launches["flash_attention"]
            else:
                _profile_serve(arch, sess, prompts, img)
            step_ms = 1e3 * stats["decode_s"] / (FAMILY_GEN - 1)
            moe = ""
            if drops:
                pre = [float(d) for s, d in drops if s > 1]
                dec = [float(d) for s, d in drops if s == 1]
                moe = (f"; MoE dropped fraction at prefill mean {np.mean(pre):.6f} (max "
                       f"{max(pre):.6f} over {len(pre)} layers), at decode mean {np.mean(dec):.6f}")
            log(f"[families] {arch} {impl} serve: {FAMILY_BATCH} x {FAMILY_PROMPT} prompt tokens, "
                f"{FAMILY_GEN} generated; prefill_s {stats['prefill_s']:.6f} "
                f"({FAMILY_BATCH * FAMILY_PROMPT / stats['prefill_s']:.1f} prompt tokens/s); decode "
                f"{step_ms:.3f} ms a step ({stats['decode_tok_per_s']:.1f} tokens/s); launches "
                f"{launches}; max_memory_allocated {peak} bytes{moe}")
            del sess
        if "flash" in impls:
            cases = _family_flash_cases(arch, cfg)
            if arch in FAMILY_FLASH_ROWS:
                rows[arch] = cases["self"]
            # The same weights in float32 (xla path): where each bf16 path's
            # rounding takes it.
            f32 = ServeSession(arch, batch=FAMILY_BATCH, max_seq=FAMILY_PROMPT + 1,
                               attention_impl="xla", dtype="float32", n_layers=depth,
                               params=tree_map(lambda t: t.float(), params))
            exact = f32.prefill(prompts, img)[0][:, :cfg.vocab].cpu()
            del f32
            torch.cuda.empty_cache()
            # A planted fault the checks must see: keys 64..127 (one KV tile)
            # dropped in every flash call of the prefill.
            with _dropped_kv_tile():
                bad = ServeSession(arch, batch=FAMILY_BATCH, max_seq=FAMILY_PROMPT + 1,
                                   attention_impl="flash", n_layers=depth, params=params
                                   ).prefill(prompts, img)[0][:, :cfg.vocab].cpu()
            _flash_rule(arch, "prefill", first["flash"], first["xla"], exact, bad)
        if not _flash_fits(cfg) and cfg.uses_attention:
            _refuses_flash(arch, lambda: ServeSession(
                arch, batch=FAMILY_BATCH, max_seq=65, attention_impl="flash", n_layers=depth,
                params=params).prefill(prompts[:, :64], img))
        del params, first
    # The audio encoder: forward_train over frames, as the reference serves
    # it, under "xla" and "flash" (hd 80, not causal: a launch a layer).
    cfg = get_config(FAMILY_AUDIO)
    torch.cuda.empty_cache()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == count_params_analytical(cfg), f"[families] {FAMILY_AUDIO}: {n_params}")
    frames = torch.from_numpy(rng.normal(size=(FAMILY_BATCH, FAMILY_PROMPT, cfg.d_frontend))
                              .astype(np.float32)).cuda()
    first = {}
    for impl in ("xla", "flash"):
        run_cfg = cfg.scaled(attention_impl=impl)
        with torch.inference_mode():
            forward_train(params, {"frames": frames[:, :64]}, run_cfg)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            logits, _ = forward_train(params, {"frames": frames}, run_cfg)
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
        launches = _launches()
        want_flash = FAMILY_FLASH_LAYERS[FAMILY_AUDIO] if impl == "flash" else 0
        others = {k: v for k, v in launches.items() if k != "flash_attention" and v}
        check(tuple(logits.shape) == (FAMILY_BATCH, FAMILY_PROMPT, cfg.padded_vocab)
              and bool(torch.isfinite(logits[..., :cfg.vocab]).all())
              and launches["flash_attention"] == want_flash and not others,
              f"[families] {FAMILY_AUDIO} {impl}: logits {tuple(logits.shape)}, launches "
              f"{launches}, expected {want_flash} flash")
        if impl == "flash":
            flash[FAMILY_AUDIO] = launches["flash_attention"]
        log(f"[families] {FAMILY_AUDIO} (audio encoder) {impl} at full width, all {cfg.n_layers} "
            f"layers: {n_params} parameters in bf16; forward_train on {FAMILY_BATCH} x "
            f"{FAMILY_PROMPT} frames in {enc_s:.6f} s ({FAMILY_BATCH * FAMILY_PROMPT / enc_s:.1f} "
            f"frames/s); launches {launches}; logits finite; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} bytes; {smi}")
        first[impl] = logits[..., :cfg.vocab].float().cpu()
        del logits
    rows[FAMILY_AUDIO] = _family_flash_cases(FAMILY_AUDIO, cfg)["self"]
    with torch.inference_mode():
        exact = forward_train(tree_map(lambda t: t.float(), params), {"frames": frames},
                              cfg.scaled(dtype="float32"))[0][..., :cfg.vocab].cpu()
        torch.cuda.empty_cache()
        with _dropped_kv_tile():
            bad = forward_train(params, {"frames": frames}, cfg.scaled(attention_impl="flash")
                                )[0][..., :cfg.vocab].float().cpu()
    _flash_rule(FAMILY_AUDIO, "forward_train", first["flash"], first["xla"], exact, bad)
    del params
    return flash, rows


def _flash_rule(arch: str, what: str, flash, xla, exact, bad) -> None:
    """Phase 19's rule for a model path's logits under "flash", against the
    same path under "xla" and in float32 on the same weights: flash within
    LM_TOL of xla where bf16 itself keeps xla within LM_TOL of float32;
    everywhere, flash no farther from float32 than xla is, plus LM_TOL, and
    ``bad`` (the path with a KV tile dropped in every flash call) farther."""
    rel = {"flash-xla": _rel(flash, xla), "flash-f32": _rel(flash, exact),
           "xla-f32": _rel(xla, exact), "planted-f32": _rel(bad, exact)}
    log(f"[families] {arch}: {what} logits relative norm {json.dumps(rel)}; max |err| "
        f"flash-xla {_err(flash, xla):.6f}")
    check(rel["flash-xla"] <= LM_TOL or rel["xla-f32"] > LM_TOL,
          f"[families] {arch}: flash vs xla {what} logits {rel}, bound {LM_TOL}")
    check(rel["flash-f32"] <= rel["xla-f32"] + LM_TOL < rel["planted-f32"],
          f"[families] {arch}: {what} logits against float32 {rel}, bound {LM_TOL}")


def _profile_serve(arch: str, sess, prompts, img, tag: str = "[families]",
                   smi: str = "") -> None:
    """A prefill and one decode step (at the prompt's end) under
    ``torch.profiler``: each one's wall, the device's busy share of it, its
    device kernels and the top torch ops by device time. On a mesh the
    parameters are gathered once before both, as ``generate`` gathers them."""
    from torch.profiler import ProfilerActivity, profile

    with sess.gathered():
        logits, cache = sess.prefill(prompts, img)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        for step, run in (("prefill", lambda: sess.prefill(prompts, img)),
                          ("decode step", lambda: sess.decode(cache, tok, prompts.shape[1]))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(end - start for start, end in _device_intervals(prof.events()))
            ops = sorted((e for e in prof.key_averages()
                          if e.key.startswith("aten::") and e.self_device_time_total > 0),
                         key=lambda e: -e.self_device_time_total)
            total = max(sum(e.self_device_time_total for e in ops), 1e-9)
            top = ", ".join(f"{e.key} {100 * e.self_device_time_total / total:.1f} %"
                            for e in ops[:4])
            log(f"{tag} {arch} profiled {step} (torch.profiler): {1e3 * wall:.3f} ms wall, "
                f"device busy {busy / 1e3:.3f} ms = {100 * busy / (1e6 * wall):.2f} %, "
                f"{len(kernels)} device kernels and copies; top ops by device time: {top}"
                + (f"; {smi}" if smi else ""))


@contextlib.contextmanager
def _dropped_kv_tile():
    """The model's flash entry replaced by one that loses keys 64..127."""
    from repro_torch.models import layers

    real = layers.flash_attention_bshd

    def drop_tile(q, k, v, q_pos, k_pos, *, causal):
        keep = torch.ones(k.shape[1], dtype=torch.bool, device=k.device)
        keep[64:128] = False
        return real(q, k[:, keep], v[:, keep], q_pos, k_pos[:, keep], causal=causal)

    layers.flash_attention_bshd = drop_tile
    try:
        yield
    finally:
        layers.flash_attention_bshd = real


def _family_flash_cases(arch: str, cfg) -> dict:
    """The kernel at the config's attention shapes in the serve run (the
    vlm's non-causal cross attention over the image tokens too), on normal
    operands, held to its plain version elementwise and by row, with its
    scored tiles equal to the skip rule's; timed a launch through the
    wrapper (CUDA events) and alone on the device (a replayed CUDA graph),
    beside its bound, its plain version and scaled_dot_product_attention.
    Returns a kernels-line row by shape label (launches 0: the caller's)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bshd_cuda,
        flash_attention_bshd_reference,
    )

    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    shapes = [("self", FAMILY_PROMPT, cfg.causal)]
    if cfg.family == "vlm":
        shapes.append(("cross", cfg.n_image_tokens, False))
    rows = {}
    for label, sk, causal in shapes:
        ops = _gqa_inputs(FAMILY_BATCH, FAMILY_PROMPT, sk, h, kh, hd, torch.bfloat16, seed=sk)
        err, row, tiles = _flash_case(flash_attention_bshd_cuda, flash_attention_bshd_reference,
                                      ops, causal, h, f"{arch} {label}")
        kernel = lambda *a: flash_attention_bshd_cuda(*a, causal=causal)  # noqa: E731
        plain = lambda *a: flash_attention_bshd_reference(*a, causal=causal)  # noqa: E731
        q4, k4, v4 = (t.transpose(1, 2) for t in ops[:3])
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=causal, enable_gqa=True)
        times = {}
        for name, fn, calls, rounds in (("kernel", kernel, [ops], 10), ("plain", plain, [ops], 2),
                                        ("sdpa", sdpa, [()], 10)):
            _time_ms(fn, calls, 2)
            times[name] = _time_ms(fn, calls, rounds)
        graph = _graph(kernel, [ops])
        device_ms = _replay_ms(graph)
        del graph
        kp = ops[4] if causal else torch.zeros_like(ops[4])  # not causal: every pair visible
        bound, pairs = _flash_bound(ops[3], kp, hd, h, kh)
        log(f"[families] {arch} {label} attention, the kernel vs its plain version (B "
            f"{FAMILY_BATCH}, Sq {FAMILY_PROMPT}, Sk {sk}, H {h}, KH {kh}, hd {hd}, bf16, "
            f"{'causal' if causal else 'not causal'}): max |err| {err:.3e} (bound "
            f"{FLASH_TOL['bfloat16']}), max row error {row:.3e} (bound {FLASH_ROW_TOL['bfloat16']}), "
            f"{tiles} KV tiles scored (== the skip rule); {times['kernel']:.6f} ms a launch, "
            f"{device_ms:.6f} ms alone on the device (a CUDA graph of {GRAPH_LAUNCHES} launches), "
            f"bound {bound[0]:.6f} ms ({bound[1]}, {pairs} pairs), "
            f"{100 * bound[0] / times['kernel']:.2f} % of it a launch, "
            f"{100 * bound[0] / device_ms:.2f} % alone; plain version {times['plain']:.6f} ms; "
            f"scaled_dot_product_attention (enable_gqa) {times['sdpa']:.6f} ms")
        if label == "self" and arch in FAMILY_FLASH_BEFORE:
            call_ms, alone_ms = FAMILY_FLASH_BEFORE[arch]
            log(f"[families] {arch} self attention before the exact-width plan and the lean launch "
                f"path: {call_ms:.6f} ms a launch, {alone_ms:.6f} ms alone (an earlier run on the "
                f"same card model); now {times['kernel']:.6f} and {device_ms:.6f} ms, "
                f"{call_ms / times['kernel']:.2f} x and {alone_ms / device_ms:.2f} x faster")
        rows[label] = _row(FAMILY_FLASH_ROWS.get(arch, f"flash_attention[{arch} {label}]"),
                           "src/repro_torch/kernels/csrc/flash_attention.cu",
                           "src/repro/kernels/flash_attention.py:71", 0, times["kernel"],
                           times["plain"], bound, times["sdpa"])
        rows[label].update(max_abs_err=err, max_row_rel_err=row, tiles_scored=tiles,
                           device_ms=device_ms)
        del ops, q4, k4, v4
    return rows


def _refuses_flash(arch: str, run) -> None:
    """``run``, a model call under ``attention_impl="flash"`` on heads the
    kernel lacks, must raise ``ValueError`` on the card and launch nothing
    (no plain fallback)."""
    _reset_launches()
    try:
        with torch.inference_mode():
            run()
    except ValueError as e:
        check(_launches()["flash_attention"] == 0, f"[families] {arch}: flash launched")
        log(f"[families] {arch}: attention_impl 'flash' refused on the card: {e}")
        return
    check(False, f"[families] {arch}: attention_impl 'flash' ran on heads the kernel lacks")


def _families_f32() -> None:
    """19c: full width in float32 at a cut depth: decode against teacher
    forcing on the card (MLA, ssm, hybrid, vlm), and the MoE card against
    the port's CPU path (routing drops included)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import forward_train, init_model
    from repro_torch.models.params import tree_map

    b, s, decoded = FAMILY_TF_SHAPE
    for arch in ("minicpm3-4b", "mamba2-780m", "zamba2-7b", "llama-3.2-vision-90b"):
        depth = FAMILY_F32_DEPTH.get(arch, 2)
        cfg = get_config(arch).scaled(n_layers=depth, dtype="float32")
        torch.cuda.empty_cache()
        params = init_model(torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")
        _open_gates(params)
        batch = _on({k: v for k, v in _family_batch(cfg, b, s, seed=5).items() if k != "labels"},
                    "cuda")
        err, rel = _teacher_forcing(params, cfg, batch, decoded)
        # In relative norm at full width (the caches are bf16 whatever the
        # dtype, as the reference's, and the logits' scale grows with the
        # width), as phase 12 restates the reference's flash bound.
        log(f"[families] {arch} float32 at full width, {depth} layers: decode vs teacher forcing "
            f"({b} x {s} tokens, the last {decoded} decoded): relative norm {rel:.3e} (bound "
            f"{FAMILY_TF_TOL}), max |err| {err:.3e}")
        check(rel <= FAMILY_TF_TOL, f"[families] {arch} float32: decode vs teacher forcing {rel}")
        del params, batch
    arch = "moonshot-v1-16b-a3b"
    cfg = get_config(arch).scaled(n_layers=2, dtype="float32")
    torch.cuda.empty_cache()
    card = init_model(torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")
    host = tree_map(lambda t: t.cpu(), card)
    batch = _family_batch(cfg, *FAMILY_MOE_SHAPE, seed=6)
    with torch.inference_mode():
        lc, ac = forward_train(card, _on(batch, "cuda"), cfg)
        lh, ah = forward_train(host, _on(batch, "cpu"), cfg)
    rel = _rel(lc.cpu()[..., :cfg.vocab], lh[..., :cfg.vocab])
    drop_c, drop_h = float(ac["moe_dropped_frac"]), float(ah["moe_dropped_frac"])
    check(rel <= FAMILY_CARD_TOL and drop_c == drop_h,
          f"[families] {arch} float32: card vs CPU logits {rel}, dropped {drop_c} vs {drop_h}")
    log(f"[families] {arch} float32 at full width, 2 layers, {FAMILY_MOE_SHAPE[0]} x "
        f"{FAMILY_MOE_SHAPE[1]} tokens (group {FAMILY_MOE_SHAPE[0] * FAMILY_MOE_SHAPE[1]}, capacity "
        f"{max(1, int(cfg.moe_capacity_factor * FAMILY_MOE_SHAPE[0] * FAMILY_MOE_SHAPE[1] * cfg.experts_per_token / cfg.n_experts))}): "
        f"card vs CPU logits relative norm {rel:.3e} (bound {FAMILY_CARD_TOL}); dropped fraction "
        f"{drop_c:.6f} on both; balance {float(ac['moe_balance_loss']):.6f} vs "
        f"{float(ah['moe_balance_loss']):.6f}")
    del card, host


def phase_families() -> tuple[dict, dict]:
    """19: the other LM families on the card (see the module docstring).
    Returns the flash launches of the full-width paths by config and the
    kernel rows of FAMILY_FLASH_ROWS by config."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    smoke_flash = _families_smoke()
    t_smoke = time.perf_counter() - t_phase
    flash, rows = _families_serve(smi)
    t_serve = time.perf_counter() - t_phase - t_smoke
    _families_f32()
    torch.cuda.empty_cache()
    log(f"[families] phase 19 took {time.perf_counter() - t_phase:.3f} s (smoke {t_smoke:.3f}, "
        f"full-width serve {t_serve:.3f}); flash launches: serve {flash}, smoke teacher forcing "
        f"{smoke_flash}")
    return flash, rows


# ---------------------------------------------------------------- phase 20


def _logical_mesh(shape, names=("data", "model")):
    from repro_torch.distributed.mesh import make_mesh

    return make_mesh(shape, names, devices=[torch.device(SHARD_DEVICE)] * math.prod(shape))


def _timed_steps(loop) -> tuple[list, list]:
    """Wrap ``loop.step_fn`` to record each synchronised step's seconds and
    loss (read after the timing); returns the two lists."""
    times: list[float] = []
    losses: list[float] = []
    step_fn = loop.step_fn

    def timed(params, opt_state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(out[2]["loss"]))
        return out

    loop.step_fn = timed
    return times, losses


def _host_ms(fn) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _held_bytes(tree, mesh) -> list[int]:
    """Bytes of the blocks each mesh position holds, over a placed tree."""
    from repro_torch.models.params import tree_leaves

    return [sum(t.block(pos).numel() * t.block(pos).element_size() for t in tree_leaves(tree))
            for pos in np.ndindex(*mesh.devices.shape)]


def _sharded_smollm(one_device: dict, work: Path, smi: str) -> dict:
    """smollm-135m at full width on 2 x 2 logical shards: phase 18's init,
    data and schedule, each step's loss against phase 18's."""
    from repro_torch.distributed.sharding import gather_tree, place_tree
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw_init

    mesh = _logical_mesh(SHARD_TRAIN_MESH)
    loop = TrainLoop(TRAIN_ARCH, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ, schedule=TRAIN_SCHEDULE,
                     mesh=mesh, ckpt_dir=str(work / "ckpt"), ckpt_every=SHARD_TRAIN_CKPT)
    cfg = loop.cfg
    check(cfg.dtype == "bfloat16" and cfg.remat == "full" and cfg.attention_impl == "xla"
          and loop.device == torch.device(SHARD_DEVICE), f"[sharded train] config {cfg}")
    params = init_model(0, cfg, SHARD_DEVICE)
    state = {"params": params, "opt": adamw_init(params)}
    placed, place_ms = _host_ms(lambda: {"params": place_tree(state["params"], loop.param_sh),
                                         "opt": place_tree(state["opt"], loop.opt_sh)})
    _, batch_ms = _host_ms(lambda: place_tree(loop.ds.batch(0), loop.batch_sh))
    gathered, gather_ms = _host_ms(lambda: gather_tree(placed["params"], SHARD_DEVICE))
    check(all(g is p for g, p in zip(tree_leaves(gathered), tree_leaves(params))),
          "[sharded train] gathering replicated params copied them")
    _, host_ms = _host_ms(lambda: gather_tree(placed, "cpu"))
    del params, state, placed, gathered
    torch.cuda.empty_cache()

    step_fn = loop.step_fn
    times, losses = _timed_steps(loop)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    params, opt_state, flags = loop.run(SHARD_TRAIN_STEPS, log_every=SHARD_TRAIN_STEPS)
    wall = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    loop.step_fn = step_fn
    check(not any(launches.values()), f"[sharded train] the sharded train path launched {launches}")
    ref = one_device["losses"][:SHARD_TRAIN_STEPS]
    diffs = [abs(a - b) for a, b in zip(losses, ref)]
    check(len(losses) == SHARD_TRAIN_STEPS and all(np.isfinite(losses))
          and max(diffs) <= SHARD_LOSS_TOL,
          f"[sharded train] losses {losses} vs one device {ref}: {diffs} > {SHARD_LOSS_TOL}")
    check(all(len(t.blocks) == 1 and t.dtype == torch.bfloat16 for t in tree_leaves(params))
          and all(len(t.blocks) == SHARD_TRAIN_MESH[0] for t in tree_leaves(opt_state["m"])
                  if t.sharding.spec != tuple(None for _ in t.shape))
          and int(opt_state["step"].full()) == SHARD_TRAIN_STEPS,
          "[sharded train] state placement after the run")
    med = float(np.median(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[sharded train] TrainLoop({TRAIN_ARCH!r}, mesh {SHARD_TRAIN_MESH} of logical shards of "
        f"{SHARD_DEVICE}): profile 'dp' (params replicated, one tensor a leaf; moments ZeRO-1 over "
        f"'data'; the batch over ('data', 'model'): 4 shards of {TRAIN_BATCH // 4} rows), "
        f"{cfg.n_layers} layers, bf16, remat {cfg.remat!r}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a "
        f"step, schedule {TRAIN_SCHEDULE} at lr {loop.opt_cfg.lr}; {SHARD_TRAIN_STEPS} steps in "
        f"{wall:.3f} s (straggler flags {flags}); kernel launches {launches}")
    log(f"[sharded train] losses a step {[round(x, 6) for x in losses]}; phase 18's one-device "
        f"{[round(x, 6) for x in ref]}; |difference| max {max(diffs):.3e} (<= {SHARD_LOSS_TOL}), "
        f"at step {int(np.argmax(diffs)) + 1}; each {[float(f'{d:.3e}') for d in diffs]}")
    log(f"[sharded train] synchronised step: median {1e3 * med:.3f} ms over steps 2-"
        f"{SHARD_TRAIN_STEPS} (min {1e3 * min(times[1:]):.3f}, max {1e3 * max(times[1:]):.3f}; "
        f"first {1e3 * times[0]:.3f}) against phase 18's {one_device['ms']:.3f} ms one-device "
        f"({100 * (1e3 * med / one_device['ms'] - 1):+.2f} %); {tokens / med:.1f} tokens/s; "
        f"max_memory_allocated {peak} bytes against phase 18's {one_device['peak']}; host ms: "
        f"placing the state {place_ms:.3f}, placing a batch {batch_ms:.3f}, gathering the params "
        f"on the card {gather_ms:.3f} (replicated: no copy), gathering the state to the host "
        f"{host_ms:.3f}; {smi}")
    _profile_train_step(loop, params, opt_state, "[sharded train]")
    return {"losses": losses, "mesh": mesh}


def _check_restored_blocks(params, opt, ckpt_dir: Path, step: int) -> int:
    """Every block of the restored state bit-equal to the saved leaf's
    slice; returns the blocks compared."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.distributed.sharding import ShardedTensor
    from repro_torch.models.params import tree_leaves

    state = {"params": params, "opt": opt}
    saved, _, _ = load_checkpoint(ckpt_dir, state, step=step)
    n = 0
    for got, leaf in zip(tree_leaves(state), tree_leaves(saved), strict=True):
        leaf = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
        if not isinstance(got, ShardedTensor):
            check(torch.equal(got.cpu(), leaf), "[sharded train] restored leaf differs")
            n += 1
            continue
        for pos in np.ndindex(*got.sharding.mesh.devices.shape):
            sl = got.sharding.block_slices(got.shape, got.sharding.block_index(pos, got.ndim))
            check(torch.equal(got.block(pos).cpu(), leaf[sl]),
                  f"[sharded train] restored block {pos} differs from the saved slice")
            n += 1
    return n


def _elastic_restore(run: dict, work: Path) -> None:
    """The 2 x 2 run's checkpoint of step SHARD_TRAIN_CKPT restored onto a 4 x 1 mesh and
    onto one device: blocks bit-equal to the saved slices, and the steps
    after it within the loss bound of the uninterrupted run's."""
    import shutil

    from repro_torch.launch.train import TrainLoop

    name = f"step_{SHARD_TRAIN_CKPT:08d}"
    for label, mesh in (("4 x 1", _logical_mesh((4, 1))), ("one device", None)):
        d = work / f"restore_{label.replace(' ', '_')}"
        shutil.copytree(work / "ckpt" / name, d / name)
        loop = TrainLoop(TRAIN_ARCH, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         schedule=TRAIN_SCHEDULE, mesh=mesh, ckpt_dir=str(d),
                         ckpt_every=10 * SHARD_TRAIN_STEPS,
                         device=SHARD_DEVICE if mesh is None else None)
        (params, opt, start), restore_ms = _host_ms(loop.restore_or_init)
        check(start == SHARD_TRAIN_CKPT, f"[sharded train] restored step {start}")
        blocks = _check_restored_blocks(params, opt, d, start)
        del params, opt
        _, losses = _timed_steps(loop)
        loop.run(SHARD_TRAIN_STEPS, log_every=SHARD_TRAIN_STEPS)
        want = run["losses"][SHARD_TRAIN_CKPT:]
        diffs = [abs(a - b) for a, b in zip(losses, want)]
        check(len(losses) == SHARD_TRAIN_STEPS - SHARD_TRAIN_CKPT and max(diffs) <= SHARD_LOSS_TOL,
              f"[sharded train] restored onto {label}: {losses} vs {want}")
        log(f"[sharded train] elastic restore of the 2 x 2 run's step {SHARD_TRAIN_CKPT} onto "
            f"{label}: {blocks} blocks bit-equal to the saved leaves' slices, restore "
            f"{restore_ms:.3f} ms of host time; steps {SHARD_TRAIN_CKPT + 1}-{SHARD_TRAIN_STEPS} "
            f"losses {[round(x, 6) for x in losses]} vs the uninterrupted 2 x 2 run's "
            f"{[round(x, 6) for x in want]}, |difference| max {max(diffs):.3e} "
            f"(<= {SHARD_LOSS_TOL})")
        del loop
        torch.cuda.empty_cache()


def _sharded_mamba(smi: str) -> None:
    """mamba2-780m at full width ("tp": ZeRO-3, fsdp -> 'data', tp ->
    'model') on 2 x 2 logical shards against its one-device run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.params import tree_leaves

    runs = {}
    cut = get_config(SHARD_MAMBA).scaled(n_layers=SHARD_MAMBA_LAYERS)
    for label, mesh in (("one device", None), ("2 x 2", _logical_mesh(SHARD_TRAIN_MESH))):
        loop = TrainLoop(SHARD_MAMBA, global_batch=SHARD_MAMBA_BATCH, seq=SHARD_MAMBA_SEQ,
                         schedule=TRAIN_SCHEDULE, mesh=mesh, cfg_override=cut,
                         device=SHARD_DEVICE if mesh is None else None)
        times, losses = _timed_steps(loop)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, _ = loop.run(SHARD_MAMBA_STEPS, log_every=SHARD_MAMBA_STEPS)
        wall = time.perf_counter() - t0
        runs[label] = (losses, times, torch.cuda.max_memory_allocated())
        if mesh is not None:
            state = {"params": params, "opt": opt}
            held = _held_bytes(state, mesh)
            dense = sum(math.prod(t.shape) * t.dtype.itemsize for t in tree_leaves(state))
            tensors = sum(t.nbytes for t in tree_leaves(state))
            check(tensors == dense and max(held) < dense,
                  f"[sharded train] mamba2 blocks: held {held}, tensors {tensors}, dense {dense}")
            log(f"[sharded train] {SHARD_MAMBA} state on 2 x 2 (ZeRO-3): bytes held by each "
                f"position's blocks {held} (params + moments + step; {[round(h / dense, 4) for h in held]} "
                f"of the leaves' {dense} bytes); the distinct tensors hold {tensors} bytes, "
                f"each block once")
        log(f"[sharded train] {SHARD_MAMBA} at full width ({loop.cfg.n_layers} layers, bf16, "
            f"remat {loop.cfg.remat!r}, {SHARD_MAMBA_BATCH} x {SHARD_MAMBA_SEQ}) on {label}: "
            f"{SHARD_MAMBA_STEPS} steps in {wall:.3f} s, ms a step {[round(1e3 * t, 3) for t in times]}, "
            f"losses {[round(x, 6) for x in losses]}, max_memory_allocated "
            f"{runs[label][2]} bytes; {smi}")
        del loop, params, opt
        torch.cuda.empty_cache()
    one, sharded = runs["one device"][0], runs["2 x 2"][0]
    diffs = [abs(a - b) for a, b in zip(sharded, one)]
    check(max(diffs) <= SHARD_LOSS_TOL, f"[sharded train] mamba2 losses {sharded} vs {one}")
    log(f"[sharded train] {SHARD_MAMBA} 2 x 2 vs one device: |loss difference| {diffs} "
        f"(<= {SHARD_LOSS_TOL}); median ms a step {1e3 * float(np.median(runs['2 x 2'][1][1:])):.3f} "
        f"vs {1e3 * float(np.median(runs['one device'][1][1:])):.3f}")


def _sharded_audio(smi: str) -> None:
    """hubert-xlarge at full width, 18c's cut, bf16, on 2 x 2 logical
    shards (the tensor-parallel train step) against its one-device loop:
    each step's loss, the ms a step of both, the bytes a position holds and
    computes with."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.tensor_parallel import gather_model_blocks, trains_tensor_parallel
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamWConfig

    runs = {}
    b, s = SHARD_AUDIO_SHAPE
    cut = get_config(SHARD_AUDIO).scaled(n_layers=SHARD_AUDIO_LAYERS)
    mesh = _logical_mesh(SHARD_TRAIN_MESH)
    check(trains_tensor_parallel(cut, mesh), f"[sharded train] {SHARD_AUDIO} trains gathered")
    for label, on in (("one device", None), ("2 x 2", mesh)):
        loop = TrainLoop(SHARD_AUDIO, global_batch=b, seq=s, schedule=TRAIN_SCHEDULE, mesh=on,
                         cfg_override=cut, device=SHARD_DEVICE if on is None else None,
                         opt=AdamWConfig(lr=SHARD_AUDIO_LR, weight_decay=0.0))
        times, losses = _timed_steps(loop)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt, _ = loop.run(SHARD_TRAIN_STEPS, log_every=SHARD_TRAIN_STEPS)
        wall = time.perf_counter() - t0
        runs[label] = (losses, times, torch.cuda.max_memory_allocated())
        held = ""
        if on is not None:
            state = {"params": params, "opt": opt}
            dense = sum(math.prod(t.shape) * t.dtype.itemsize for t in tree_leaves(state))
            whole = sum(math.prod(t.shape) * t.dtype.itemsize for t in tree_leaves(params))
            computes = gather_model_blocks(params, mesh, cut).bytes_by_position
            check(max(computes.values()) < SERVE_TP_BYTES_SHARE * whole,
                  f"[sharded train] {SHARD_AUDIO}: a position computes with {computes} of {whole}")
            held = (f"; bytes held by each position's blocks {_held_bytes(state, mesh)} (params + "
                    f"moments + step, of the leaves' {dense}); bytes of the 'model' blocks each "
                    f"position gathers and computes with {sorted(set(computes.values()))} of the "
                    f"params' {whole} (ratio {max(computes.values()) / whole:.4f})")
        log(f"[sharded train] {SHARD_AUDIO} at full width ({cut.n_layers} of 48 layers, bf16, "
            f"remat {cut.remat!r}, attention {cut.attention_impl!r}, {b} x {s} frames, schedule "
            f"{TRAIN_SCHEDULE} at lr {SHARD_AUDIO_LR}) on {label}"
            f"{' (tensor-parallel train step)' if on is not None else ''}: {SHARD_TRAIN_STEPS} "
            f"steps in {wall:.3f} s, ms a step {[round(1e3 * t, 3) for t in times]}, losses "
            f"{[round(x, 6) for x in losses]}, max_memory_allocated {runs[label][2]} bytes{held}; "
            f"{smi}")
        del loop, params, opt
        torch.cuda.empty_cache()
    one, sharded = runs["one device"][0], runs["2 x 2"][0]
    diffs = [abs(a - b_) for a, b_ in zip(sharded, one)]
    check(len(sharded) == SHARD_TRAIN_STEPS and all(np.isfinite(sharded))
          and max(diffs) <= SHARD_LOSS_TOL,
          f"[sharded train] {SHARD_AUDIO} losses {sharded} vs {one}")
    log(f"[sharded train] {SHARD_AUDIO} 2 x 2 tensor-parallel vs one device: |loss difference| "
        f"{[float(f'{d:.3e}') for d in diffs]} (<= {SHARD_LOSS_TOL}); median ms a step "
        f"{1e3 * float(np.median(runs['2 x 2'][1][1:])):.3f} vs "
        f"{1e3 * float(np.median(runs['one device'][1][1:])):.3f}")


def _sharded_grads_f32() -> dict:
    """Float32 gradients at 2 layers, full width, the three archs: the sharded
    step's reduced blocks against ``loss_and_grads`` on one device."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed.lm_sharding import batch_spec_tree, named_tree, train_state_specs
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch.steps import loss_and_grads, sharded_loss_and_grads
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_leaves

    from repro_torch.distributed.tensor_parallel import trains_tensor_parallel
    from repro_torch.launch import steps

    mesh = _logical_mesh(SHARD_TRAIN_MESH)
    b, s = SHARD_GRAD_SHAPE
    out = {}
    for arch in (TRAIN_ARCH, SHARD_MAMBA, SHARD_AUDIO):
        cfg = get_config(arch).scaled(n_layers=SHARD_GRAD_LAYERS, dtype="float32")
        params = init_model(0, cfg, SHARD_DEVICE)
        batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMDataset(
            vocab=cfg.vocab, seq_len=s, global_batch=b, seed=3, family=cfg.family,
            d_frontend=cfg.d_frontend).batch(0).items()}
        loss, _, grads = loss_and_grads(params, batch, cfg)
        pspecs, _, gspecs = train_state_specs(cfg)
        placed = place_tree(params, named_tree(mesh, pspecs))
        bp = place_tree(batch, named_tree(mesh, batch_spec_tree(cfg, mesh, batch)))
        tp_step = trains_tensor_parallel(cfg, mesh)
        check(tp_step == (arch == SHARD_AUDIO), f"[sharded train] {arch}: tensor-parallel "
                                                f"train step {tp_step}")

        def errors() -> tuple:
            s_loss, _, s_grads = sharded_loss_and_grads(placed, bp, cfg, named_tree(mesh, gspecs))
            errs = [_rel(g.full(), w) for g, w in zip(tree_leaves(s_grads), tree_leaves(grads))]
            return s_loss, errs, abs(float(s_loss) - float(loss)) / abs(float(loss))

        s_loss, errs, loss_err = errors()
        worst = _leaf_names(grads)[int(np.argmax(errs))]
        check(max(errs) <= SHARD_GRAD_TOL and loss_err <= SHARD_GRAD_TOL,
              f"[sharded train] {arch} float32 gradients {max(errs):.3e} ({worst}), "
              f"loss {loss_err:.3e}")
        planted = ""
        if tp_step:  # each shard's gradient reduced into its neighbour's model block
            with _patched(steps, "_model_block_grad", lambda real: lambda g, leaf, region: real(
                    g[1:] + g[:1], leaf, region)):
                bad = errors()[1]
            check(max(bad) > SHARD_GRAD_TOL, f"[sharded train] {arch}: a shard's gradient "
                                             f"reduced into its neighbour's block passes: {bad}")
            planted = (f"; each shard's gradient reduced into its neighbour's model block, "
                       f"refused: worst leaf {max(bad):.3e}, {max(bad) / SHARD_GRAD_TOL:.1f} x "
                       f"the bound")
        path = ("tensor-parallel: each position's 'model' blocks, its share of the forward and "
                "backward" if tp_step else "gathered")
        log(f"[sharded train] {arch} at full width, {SHARD_GRAD_LAYERS} layers, float32 (TF32 "
            f"off), {b} x {s} on 2 x 2 logical shards (profile "
            f"{'dp' if arch == TRAIN_ARCH else 'tp'}, {path}): loss {float(s_loss):.7f} vs one "
            f"device {float(loss):.7f} ({loss_err:.3e}); {len(errs)} gradient leaves, worst "
            f"{worst} {max(errs):.3e} relative L2 (<= {SHARD_GRAD_TOL}), median "
            f"{float(np.median(errs)):.3e}{planted}")
        if arch == TRAIN_ARCH:
            out = {"params": params, "cfg": cfg}
        del placed, grads
    return out


def _emulated_mean(stacked: np.ndarray) -> np.ndarray:
    """``compressed_psum_mean`` in NumPy: a shared amax, int8 against the
    shared scale (half to even), an exact int32 sum, dequantize, / n."""
    amax = np.float32(np.max(np.abs(stacked)))
    scale = np.float32(max(amax, np.float32(1e-12))) / np.float32(127.0)
    q = np.clip(np.round(stacked / scale), -127, 127).astype(np.int8)
    total = q.astype(np.int32).sum(axis=0, dtype=np.int32)
    return total.astype(np.float32) * scale / np.float32(len(stacked))


def _compressed_mean(f32: dict) -> None:
    """``compressed_psum_mean`` over 8 logical 'pod' shards: the reference
    test's [8, 64] and eight single-row gradients of smollm's full-width
    embedding, bit-equal to the NumPy emulation and within 0.02 of the
    exact mean."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed.compression import compressed_psum_mean
    from repro_torch.distributed.sharding import NamedSharding, P, place
    from repro_torch.launch.steps import loss_and_grads

    mesh = _logical_mesh((SHARD_PODS,), ("pod",))
    cfg, params = f32["cfg"], f32["params"]
    b, s = SHARD_COMP_SHAPE
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=4).batch(0).items()}
    rows = [loss_and_grads(params, {k: v[i:i + 1] for k, v in batch.items()}, cfg)[2]["tok_embed"]
            for i in range(b)]
    cases = {"[8, 64]": torch.from_numpy(
                 np.random.default_rng(0).normal(size=(SHARD_PODS, 64)).astype(np.float32)).cuda(),
             f"tok_embed {tuple(rows[0].shape)} x 8": torch.stack(rows)}
    del rows
    for label, stacked in cases.items():
        placed = place(stacked, NamedSharding(mesh, P("pod", *([None] * (stacked.ndim - 1)))))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = compressed_psum_mean({"g": placed}, mesh, "pod")["g"]
        end.record()
        torch.cuda.synchronize()
        got = out.full().cpu().numpy()
        host = stacked.cpu().numpy()
        want = _emulated_mean(host)
        exact = host.mean(axis=0)
        err = float(np.abs(got[0] - exact).max() / (np.abs(exact).max() + 1e-9))
        check(all(got[i].tobytes() == want.tobytes() for i in range(SHARD_PODS))
              and err < SHARD_COMP_TOL,
              f"[sharded train] compressed mean {label}: emulation equal "
              f"{[got[i].tobytes() == want.tobytes() for i in range(SHARD_PODS)]}, error {err}")
        log(f"[sharded train] compressed_psum_mean over {SHARD_PODS} logical 'pod' shards of "
            f"{label}: every entry bit-equal to the NumPy emulation; max |mean - exact| / max "
            f"|exact| {err:.6f} (< {SHARD_COMP_TOL}); {start.elapsed_time(end):.3f} ms")


def _sharded_resume_child() -> int:
    """The child process (``CUBLAS_WORKSPACE_CONFIG=:4096:8``, deterministic
    algorithms): a 2 x 2 loop at a cut depth, uninterrupted against one
    failure and ``run_with_auto_resume``. Prints one JSON line."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoop, run_with_auto_resume
    from repro_torch.models.params import tree_leaves
    from repro_torch.runtime import FailureInjector

    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == ":4096:8", "CUBLAS_WORKSPACE_CONFIG")
    torch.use_deterministic_algorithms(True)
    cut = get_config(TRAIN_ARCH).scaled(n_layers=SHARD_RESUME_LAYERS)
    b, s = SHARD_RESUME_SHAPE
    common = dict(global_batch=b, seq=s, schedule=TRAIN_SCHEDULE, ckpt_every=SHARD_RESUME_EVERY,
                  cfg_override=cut, mesh=_logical_mesh(SHARD_TRAIN_MESH))
    loop_a = TrainLoop(TRAIN_ARCH, **common)
    pa, sa, _ = loop_a.run(SHARD_RESUME_STEPS, log_every=1)
    want = {m["step"]: m["loss"] for m in loop_a.metrics_log}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        loop_b = TrainLoop(TRAIN_ARCH, ckpt_dir=str(work), **common)
        (pb, sb, _), restarts = run_with_auto_resume(
            loop_b, SHARD_RESUME_STEPS, FailureInjector(fail_at_steps=SHARD_RESUME_FAIL_AT))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    logged = [(m["step"], m["loss"]) for m in loop_b.metrics_log]
    state_equal = all(
        a.sharding.same_blocks(c.sharding, a.ndim)
        and all(torch.equal(t, c.distinct_blocks()[idx]) for idx, t in a.distinct_blocks().items())
        for a, c in zip(tree_leaves({"p": pa, "s": sa}), tree_leaves({"p": pb, "s": sb})))
    print(json.dumps({"restarts": restarts, "logged": logged,
                      "losses_equal": all(loss == want[step] for step, loss in logged),
                      "state_equal": state_equal}), flush=True)
    return 0


def _sharded_resume() -> None:
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), SHARD_RESUME_FLAG],
                          env=env, capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and bool(lines),
          f"[sharded train] resume child exited {proc.returncode}: {proc.stdout[-4000:]}"
          f"{proc.stderr[-4000:]}")
    res = json.loads(lines[-1])
    check(res["restarts"] == len(SHARD_RESUME_FAIL_AT) and res["losses_equal"]
          and res["state_equal"], f"[sharded train] same-mesh resume: {res}")
    log(f"[sharded train] deterministic child (CUBLAS_WORKSPACE_CONFIG=:4096:8, "
        f"use_deterministic_algorithms): a 2 x 2 loop at {SHARD_RESUME_LAYERS} layers (full width "
        f"otherwise, bf16, {SHARD_RESUME_SHAPE[0]} x {SHARD_RESUME_SHAPE[1]}), failure at step "
        f"{SHARD_RESUME_FAIL_AT}, ckpt_every {SHARD_RESUME_EVERY}: {res['restarts']} restart, "
        f"every logged loss {res['logged']} and every block of the final state bit-equal to the "
        f"uninterrupted run's; the child took {child_s:.1f} s")


def phase_sharded_train(one_device: dict) -> None:
    """20: sharded training on meshes of logical shards of the card (see the
    module docstring); ``one_device`` is phase 18's full-width run."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_train_"))
    try:
        run = _sharded_smollm(one_device, work, smi)
        _elastic_restore(run, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t_smollm = time.perf_counter() - t_phase
    _sharded_mamba(smi)
    t_mamba = time.perf_counter() - t_phase - t_smollm
    _sharded_audio(smi)
    t_audio = time.perf_counter() - t_phase - t_smollm - t_mamba
    f32 = _sharded_grads_f32()
    _compressed_mean(f32)  # the deterministic child ran in phase 18c
    del f32
    torch.cuda.empty_cache()
    log(f"[sharded train] phase 20 took {time.perf_counter() - t_phase:.3f} s (smollm and its "
        f"restores {t_smollm:.3f}, mamba2 {t_mamba:.3f}, hubert {t_audio:.3f})")


# ---------------------------------------------------------------- phase 21


def _prefill_shards(cfg, mesh, batch: int, prompt: int) -> int:
    """The distinct data-parallel shards ``batch_spec_tree`` gives a prompt
    batch: the sharded prefill runs ``forward_prefill`` once each."""
    from repro_torch.distributed.lm_sharding import batch_spec_tree
    from repro_torch.distributed.sharding import NamedSharding

    meta = {"tokens": torch.empty((batch, prompt), device="meta")}
    return NamedSharding(mesh, batch_spec_tree(cfg, mesh, meta)["tokens"]).blocks_per_dim(2)[0]


def _check_cache_layout(cfg, cache, tag: str) -> str:
    """Every attention leaf's sequence, and the SSM state's heads, on
    'model' (the flash-decoding layout); returns the specs for the log."""
    seq = {"k": -3, "v": -3, "shared_k": 2, "shared_v": 2, "ckv": 2, "krope": 2}
    specs = {}
    for name, leaf in cache.items():
        if name == "ssm":
            check(leaf["ssm"].sharding.spec[2] == "model", f"{tag} SSM heads not on 'model'")
            specs.update({f"ssm/{k}": v.sharding.spec for k, v in leaf.items()})
            continue
        specs[name] = leaf.sharding.spec
        if name in seq:
            check(leaf.sharding.spec[seq[name] % leaf.ndim] == "model",
                  f"{tag} {name}'s sequence is not on 'model': {leaf.sharding.spec}")
    return ", ".join(f"{k} {v}" for k, v in sorted(specs.items()))


def _forced(sess, prompts, img, forced: np.ndarray) -> tuple:
    """A session's prefill, then its decode fed the one-device session's
    tokens ``forced [B, n]`` (on a mesh with the parameters gathered once):
    (logits [n, B, V] on the host, flash launches of the prefill and of the
    decode steps, prefill s, decode s, the placed cache's specs)."""
    plen, kept = prompts.shape[1], []
    with sess.gathered():
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        logits, cache = sess.prefill(prompts, img)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        pre = _launches()
        layout = "" if sess.mesh is None else _check_cache_layout(
            sess.cfg, cache, f"[sharded serve] {sess.cfg.name}")
        kept.append(logits)
        _reset_launches()
        t0 = time.perf_counter()
        for i in range(forced.shape[1] - 1):
            tok = torch.from_numpy(forced[:, i:i + 1].astype(np.int32)).cuda()
            logits, cache = sess.decode(cache, tok, plen + i)
            kept.append(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        dec = _launches()
    return torch.stack(kept).cpu(), pre, dec, prefill_s, decode_s, layout


def _step_rels(got: torch.Tensor, want, vocab: int) -> list[float]:
    """Relative norm of each step's logits (the live vocab columns)."""
    want = torch.as_tensor(np.asarray(want))
    return [_rel(g[:, :vocab], w[:, :vocab]) for g, w in zip(got, want)]


def _sharded_smollm_serve(lm: dict, mesh, smi: str) -> int:
    """21a: smollm-135m at full width and depth under "flash" on 2 x 2
    logical shards, phase 12's weights and prompts. Returns the flash
    launches of the timed generate."""
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.params import tree_leaves

    sess = ServeSession(LM_ARCH, batch=LM_BATCH, max_seq=SERVE_SHARD_MAX_SEQ, mesh=mesh,
                        attention_impl="flash", params=lm["params"])
    cfg, prompts = sess.cfg, lm["prompts"]
    shards = _prefill_shards(cfg, mesh, LM_BATCH, LM_PROMPT)
    check(all(len(t.blocks) == 1 for t in tree_leaves(sess.params)) and shards == 4,
          f"[sharded serve] {LM_ARCH}: params not replicated or {shards} prefill shards")
    sess.generate(prompts[:, :64], 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_launches()
    tokens, stats = sess.generate(prompts, LM_GEN)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    gen = tokens[:, LM_PROMPT:]
    others = {k: v for k, v in launches.items() if k != "flash_attention" and v}
    check(launches["flash_attention"] == cfg.n_layers * shards and not others,
          f"[sharded serve] generate launches {launches}, expected {cfg.n_layers} x {shards} flash")
    check(tokens.shape == (LM_BATCH, LM_PROMPT + LM_GEN) and 0 <= gen.min()
          and gen.max() < cfg.vocab, "[sharded serve] generated tokens malformed")
    step_ms = 1e3 * stats["decode_s"] / (LM_GEN - 1)
    one = lm["stats"]
    log(f"[sharded serve] ServeSession({LM_ARCH!r}, mesh {SERVE_SHARD_MESH} of logical shards of "
        f"{SHARD_DEVICE}, attention 'flash'): {cfg.n_layers} layers at full width, bf16, "
        f"phase 12's weights; {LM_BATCH} x {LM_PROMPT} prompt tokens, {LM_GEN} generated, "
        f"max_seq {SERVE_SHARD_MAX_SEQ}; profile 'dp': params replicated, the prompt batch over "
        f"('data', 'model') in {shards} prefill shards of {LM_BATCH // shards} rows, the cache's "
        f"batch over 'data' and its sequence over 'model'; launches {launches}; prefill_s "
        f"{stats['prefill_s']:.6f} ({LM_BATCH * LM_PROMPT / stats['prefill_s']:.1f} prompt "
        f"tokens/s; one device {one['prefill_s']:.6f}); decode {step_ms:.3f} ms a step "
        f"({stats['decode_tok_per_s']:.1f} tokens/s; one device "
        f"{1e3 * one['decode_s'] / (LM_GEN - 1):.3f} ms, {one['decode_tok_per_s']:.1f} tokens/s); "
        f"max_memory_allocated {peak} bytes ({peak - base} above the {base} held before); greedy "
        f"tokens equal to phase 12's: {float((gen == lm['tokens']).mean()):.4f}; {smi}")
    # The kernel at a prefill shard's shape, held to its plain version.
    from repro_torch.kernels.flash_attention import (
        flash_attention_bshd_cuda,
        flash_attention_bshd_reference,
    )

    rows = LM_BATCH // shards
    ops = _gqa_inputs(rows, LM_PROMPT, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim, torch.bfloat16, seed=21)
    err, row_err, tiles = _flash_case(flash_attention_bshd_cuda, flash_attention_bshd_reference,
                                      ops, True, cfg.n_heads, "sharded prefill shard")
    ms = _time_ms(lambda *a: flash_attention_bshd_cuda(*a, causal=True), [ops], 10)
    log(f"[sharded serve] flash at a prefill shard's shape (B {rows}, S {LM_PROMPT}, H "
        f"{cfg.n_heads}, KH {cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, bf16, causal): max "
        f"|err| {err:.3e} against its plain version, max row error {row_err:.3e}, {tiles} tiles "
        f"scored (== the skip rule); {ms:.6f} ms a launch")
    del ops
    got, pre, dec, prefill_s, decode_s, layout = _forced(sess, prompts, None, lm["tokens"])
    check(pre["flash_attention"] == cfg.n_layers * shards and dec["flash_attention"] == 0,
          f"[sharded serve] flash launches: prefill {pre}, decode {dec}")
    rels = _step_rels(got, one["logits"], cfg.vocab)
    check(max(rels) <= SERVE_SHARD_TOL, f"[sharded serve] {LM_ARCH} sharded vs one device "
          f"relative norms {rels} > {SERVE_SHARD_TOL}")
    log(f"[sharded serve] {LM_ARCH} teacher-forced on phase 12's tokens: logits relative norm "
        f"against the one-device session, prefill {rels[0]:.6f}, decode steps max "
        f"{max(rels[1:]):.6f} (each {[round(r, 6) for r in rels]}; bound {SERVE_SHARD_TOL}); "
        f"flash launches {pre['flash_attention']} in the prefill ({cfg.n_layers} x {shards} "
        f"shards), {dec['flash_attention']} in {LM_GEN - 1} decode steps; cache specs {layout}")
    # A planted fault the bound must see: a combine that loses the last
    # sequence block (the one holding the decoded positions).
    from repro_torch.models import layers

    real = layers.combine_partials
    layers.combine_partials = lambda parts: real(parts[:-1])
    try:
        bad = _step_rels(_forced(sess, prompts, None, lm["tokens"][:, :4])[0],
                         one["logits"][:4], cfg.vocab)
    finally:
        layers.combine_partials = real
    check(min(bad[1:]) > SERVE_SHARD_TOL, f"[sharded serve] a dropped block passes: {bad}")
    log(f"[sharded serve] planted fault (each decode step's combine without the block holding "
        f"positions {SERVE_SHARD_MAX_SEQ // 2}..): relative norms {[round(r, 6) for r in bad]}, "
        f"{min(bad[1:]) / SERVE_SHARD_TOL:.1f} x the bound at least")
    _profile_serve(LM_ARCH, sess, prompts, None, "[sharded serve]", smi)
    return launches["flash_attention"]


@contextlib.contextmanager
def _pinned_profile(profile: str | None):
    """The configs ``ServeSession`` reads pinned to ``profile`` inside
    the block (None: as they are), as a deployment pins its config's."""
    from repro_torch.launch import serve

    if profile is None:
        yield
        return
    with _patched(serve, "get_config",
                  lambda real: lambda arch: real(arch).scaled(parallelism=profile)):
        yield


def _sharded_families_serve(mesh, smi: str) -> dict:
    """21b: the decoders of ``SERVE_SHARD_FAMILIES`` at full width in bf16
    on the gathered path (phase 19's shapes), each on its pinned profile,
    teacher-forced on its one-device session's tokens. Returns the flash
    launches of each prefill."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeSession
    from repro_torch.launch.steps import serves_tensor_parallel
    from repro_torch.models import model as model_mod
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_map

    flash = {}
    rng = np.random.default_rng(21)
    for arch, depth in SERVE_SHARD_FAMILIES:
        full = get_config(arch)
        impl, profile = SERVE_SHARD_IMPL.get(arch, "flash"), SERVE_SHARD_PROFILE.get(arch)
        cfg = full.scaled(**{k: v for k, v in (("n_layers", depth), ("parallelism", profile))
                             if v is not None})
        check(not serves_tensor_parallel(cfg, mesh),
              f"[sharded serve] {arch} on profile {profile!r} does not take the gathered path")
        torch.cuda.empty_cache()
        params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
        _open_gates(params)
        _sharp_mla(params, cfg)
        prompts = rng.integers(0, cfg.vocab, (FAMILY_BATCH, FAMILY_PROMPT), dtype=np.int32)
        common = dict(batch=FAMILY_BATCH, max_seq=FAMILY_PROMPT + FAMILY_GEN, attention_impl=impl,
                      n_layers=depth)
        one = ServeSession(arch, params=params, **common)
        tokens, stats = one.generate(prompts, FAMILY_GEN, keep_logits=True)
        del one
        forced = tokens[:, FAMILY_PROMPT:]
        # The same weights in float32 (one device), fed the same tokens:
        # where each bf16 session's rounding takes it.
        f32 = ServeSession(arch, params=tree_map(lambda t: t.float(), params), dtype="float32",
                           **common)
        exact = _forced(f32, prompts, None, forced)[0]
        del f32
        torch.cuda.empty_cache()
        with _pinned_profile(profile):
            sess = ServeSession(arch, mesh=mesh, params=params, **common)
        check(sess.cfg.parallelism == cfg.parallelism, f"[sharded serve] {arch}: the session "
              f"serves on profile {sess.cfg.parallelism!r}, not {cfg.parallelism!r}")
        del params  # the sharded session holds its own copies
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shards = _prefill_shards(cfg, mesh, FAMILY_BATCH, FAMILY_PROMPT)
        got, pre, dec, prefill_s, decode_s, layout = _forced(sess, prompts, None, forced)
        peak = torch.cuda.max_memory_allocated()
        rels = _step_rels(got, stats["logits"], cfg.vocab)
        want = FAMILY_FLASH_LAYERS[arch] * shards if impl == "flash" else 0
        check(pre["flash_attention"] == want and dec["flash_attention"] == 0
              and not any(v for k, v in {**pre, **dec}.items() if k != "flash_attention"),
              f"[sharded serve] {arch}: launches prefill {pre}, decode {dec}; expected {want} flash")
        tol = SERVE_SHARD_BF16_TOL[arch]

        def verdict(steps: int) -> tuple:
            """The run's rule over its first ``steps`` steps: (passes,
            relative norms against one device, one device's and the sharded
            session's distance from float32): finite logits within ``tol``
            of one device, and no farther from float32 than one device is,
            plus LM_TOL."""
            logits = got if steps == FAMILY_GEN else _forced(sess, prompts, None,
                                                              forced[:, :steps])[0]
            near = _step_rels(logits, stats["logits"][:steps], cfg.vocab)
            one_f32 = max(_step_rels(torch.as_tensor(stats["logits"][:steps]), exact[:steps],
                                     cfg.vocab))
            sharded_f32 = max(_step_rels(logits, exact[:steps], cfg.vocab))
            return (bool(torch.isfinite(logits[..., :cfg.vocab]).all()) and max(near) <= tol
                    and sharded_f32 <= one_f32 + LM_TOL, near, one_f32, sharded_f32)

        ok, _, one_f32, sharded_f32 = verdict(FAMILY_GEN)
        check(ok, f"[sharded serve] {arch}: sharded vs one device relative norms {rels} (bound "
                  f"{tol}); against float32: one device {one_f32}, sharded {sharded_f32}")
        # A planted fault the rule must refuse: the prefill's last data shard
        # never writes its cache rows into the placed cache (its rows decode
        # from zeros), held by the same verdict over two steps.
        last = FAMILY_BATCH - FAMILY_BATCH // shards
        with _patched(model_mod, "_scatter_rows",
                      lambda real: lambda cache, own, lo: None if lo == last else real(cache, own,
                                                                                       lo)):
            bad_ok, bad, _, _ = verdict(2)
        check(not bad_ok, f"[sharded serve] {arch}: a lost cache shard passes the rule: {bad}")
        cut = f"{depth} of {full.n_layers} layers" if depth else f"all {full.n_layers} layers"
        log(f"[sharded serve] {arch} ({cfg.family}, profile {profile!r}, the gathered path) at "
            f"full width, {cut}, bf16, attention {impl!r}"
            + (f", q_norm scaled so that the latent scores spread about {MLA_SCORE_STD}"
               if cfg.attention == "mla" else "")
            + f", on {SERVE_SHARD_MESH}: {FAMILY_BATCH} x {FAMILY_PROMPT} prompt tokens in "
            f"{shards} prefill shards, {FAMILY_GEN} steps teacher-forced on the one-device "
            f"session's tokens: logits relative norm prefill {rels[0]:.6f}, decode max "
            f"{max(rels[1:]):.6f} (bound {tol:.6f}); against a float32 run of the same weights, "
            f"max over the steps: one device {one_f32:.6f}, sharded {sharded_f32:.6f}; a prefill "
            f"whose last data shard's cache is lost, refused by the same rule: "
            f"{[round(r, 6) for r in bad]}, {max(bad) / tol:.1f} x the bound; flash launches "
            f"prefill {pre['flash_attention']}, decode {dec['flash_attention']}; prefill "
            f"{prefill_s:.6f} s (one device {stats['prefill_s']:.6f}), decode "
            f"{1e3 * decode_s / (FAMILY_GEN - 1):.3f} ms a step (one device "
            f"{1e3 * stats['decode_s'] / (FAMILY_GEN - 1):.3f}); max_memory_allocated {peak} "
            f"bytes; cache specs {layout}; {smi}")
        if impl == "flash":
            flash[arch] = pre["flash_attention"]
        del sess, got
    return flash


def _sharded_serve_f32(mesh) -> None:
    """21c: float32 at full width and a cut depth, the sharded session on
    the card teacher-forced on the port's CPU session's tokens, on the same
    weights."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.ctx import arch_profile
    from repro_torch.launch.serve import ServeSession
    from repro_torch.launch.steps import serves_tensor_parallel
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_map

    rng = np.random.default_rng(22)
    for arch in SERVE_SHARD_IMPL:
        depth, profile = FAMILY_F32_DEPTH.get(arch, 2), SERVE_SHARD_PROFILE.get(arch)
        cfg = get_config(arch).scaled(n_layers=depth, dtype="float32",
                                      **({"parallelism": profile} if profile else {}))
        path = "tensor-parallel" if serves_tensor_parallel(cfg, mesh) else "gathered"
        check(path == "gathered" or profile is None,
              f"[sharded serve] {arch} pinned {profile!r} takes the tensor-parallel path")
        b, plen, gen = SERVE_SHARD_F32_MOE_SHAPE if cfg.family == "moe" else SERVE_SHARD_F32_SHAPE
        torch.cuda.empty_cache()
        card = init_model(torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")
        _open_gates(card)
        host = tree_map(lambda t: t.cpu(), card)
        prompts = rng.integers(0, cfg.vocab, (b, plen), dtype=np.int32)
        img = None
        if cfg.family == "vlm":
            img = rng.normal(size=(b, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
        common = dict(batch=b, max_seq=plen + gen, attention_impl=SERVE_SHARD_IMPL[arch],
                      n_layers=depth, dtype="float32")
        t0 = time.perf_counter()
        tokens, stats = ServeSession(arch, device="cpu", params=host, **common).generate(
            prompts, gen, image_embeds=img, keep_logits=True)
        cpu_s = time.perf_counter() - t0
        del host
        forced = tokens[:, plen:]
        one = _forced(ServeSession(arch, params=card, **common), prompts, img, forced)[0]
        with _pinned_profile(profile):
            sess = ServeSession(arch, mesh=mesh, params=card, **common)
        check(sess.cfg.parallelism == cfg.parallelism, f"[sharded serve] {arch}: the session "
              f"serves on profile {sess.cfg.parallelism!r}, not {cfg.parallelism!r}")
        del card
        got, pre, _, _, _, _ = _forced(sess, prompts, img, forced)
        rels = _step_rels(got, stats["logits"], cfg.vocab)
        one_rels = _step_rels(one, stats["logits"], cfg.vocab)
        # The prefill's logits read no cache; a decode step reads the bf16
        # attention caches (bf16 whatever the dtype, as the reference's),
        # whose rounding of the card's and the host's float32 K/V may part
        # by one bf16 step: there the card's one-device session is the
        # measure, and the sharded one may be no farther from the CPU.
        check(rels[0] <= FAMILY_CARD_TOL
              and all(r <= o + FAMILY_CARD_TOL for r, o in zip(rels[1:], one_rels[1:])),
              f"[sharded serve] {arch} float32: sharded card vs CPU relative norms {rels}, the "
              f"card's one-device session's {one_rels}")
        log(f"[sharded serve] {arch} float32 at full width, {depth} layers, {b} x {plen} prompt "
            f"tokens and {gen} steps on {SERVE_SHARD_MESH} (profile {arch_profile(cfg)!r}, the "
            f"{path} path, attention {SERVE_SHARD_IMPL[arch]!r}, flash launches "
            f"{pre['flash_attention']}), teacher-forced on the port's CPU session's "
            f"tokens: logits relative norm against the CPU, sharded "
            f"{[float(f'{r:.3e}') for r in rels]}, the card's one-device session "
            f"{[float(f'{r:.3e}') for r in one_rels]} (prefill bound {FAMILY_CARD_TOL}; a decode "
            f"step within {FAMILY_CARD_TOL} of one device's distance); sharded against one device "
            f"on the card {[float(f'{r:.3e}') for r in _step_rels(got, one, cfg.vocab)]}; the CPU "
            f"run took {cpu_s:.1f} s")
        del sess, got, one


def phase_sharded_serve(lm: dict) -> dict:
    """21: sharded serving on 2 x 2 logical shards of the card (see the
    module docstring); ``lm`` is phase 12's return. Returns the flash
    launches by path."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    smi = nvidia_smi_line()
    mesh = _logical_mesh(SERVE_SHARD_MESH)
    flash = {"sharded_serve": _sharded_smollm_serve(lm, mesh, smi)}
    t_smollm = time.perf_counter() - t_phase
    flash.update({f"sharded_serve:{k}": v for k, v in _sharded_families_serve(mesh, smi).items()})
    t_families = time.perf_counter() - t_phase - t_smollm
    _sharded_serve_f32(mesh)
    torch.cuda.empty_cache()
    log(f"[sharded serve] phase 21 took {time.perf_counter() - t_phase:.3f} s (smollm "
        f"{t_smollm:.3f}, the gathered bf16 decoders {t_families:.3f})")
    return flash


# ---------------------------------------------------------------- phase 21d


def _one_device_steps(one, prompts, img, forced: np.ndarray) -> tuple:
    """A one-device session's prefill logits and, for each decode step fed
    the token ``forced`` gives, a copy of the dense cache it starts from and
    its logits: what ``_same_cache_steps`` holds another session to once
    ``one``'s parameters are freed."""
    from repro_torch.models.params import tree_map

    plen, steps = prompts.shape[1], []
    with one.gathered():
        want, cache = one.prefill(prompts, img)
        for i in range(forced.shape[1] - 1):
            tok = torch.from_numpy(forced[:, i:i + 1].astype(np.int32)).cuda()
            start = tree_map(torch.clone, cache)
            logits, cache = one.decode(cache, tok, plen + i)
            steps.append((start, logits))
    return want, steps


def _same_cache_steps(one_steps: tuple, sess, prompts, img, forced: np.ndarray,
                      rows=None) -> list[float]:
    """Relative norms of ``sess``'s logits against a one-device session's
    (``one_steps``, ``_one_device_steps``): the prefill (its batch rows
    ``rows``, all by default), then each decode step fed a copy of the
    one-device session's cache (dense; the sharded step places it) and the
    token ``forced`` gives."""
    from repro_torch.models.params import tree_map

    plen, vocab = prompts.shape[1], sess.cfg.vocab
    rows = slice(None) if rows is None else rows
    want, steps = one_steps
    with sess.gathered():
        got, _ = sess.prefill(prompts, img)
        rels = [_rel(got[rows, :vocab], want[rows, :vocab])]
        for i, (start, want_i) in enumerate(steps[:forced.shape[1] - 1]):
            tok = torch.from_numpy(forced[:, i:i + 1].astype(np.int32)).cuda()
            got, _ = sess.decode(tree_map(torch.clone, start), tok, plen + i)
            rels.append(_rel(got[:, :vocab], want_i[:, :vocab]))
    return rels


def _prefill_routing(sess, prompts) -> tuple:
    """The routing of each MoE layer of ``sess``'s prefill of ``prompts``:
    (dropped (token, choice) pairs a layer, summed over the data shards,
    the pairs a layer, each layer's expert choices ``[groups, g, k]`` on the
    host, the data shards' groups in order), read from every ``moe.plan``
    the prefill's layers make."""
    from repro_torch.models import moe

    seen: list = []
    real = moe.aux_metrics

    def spy(pl, cfg):
        seen.append((int((~pl.within).sum()), pl.within.numel(), pl.experts.cpu()))
        return real(pl, cfg)

    moe.aux_metrics = spy
    try:
        with sess.gathered():
            sess.prefill(prompts)
    finally:
        moe.aux_metrics = real
    layers = sess.cfg.n_layers
    shards = len(seen) // layers  # the prefill runs its data shards one after another
    at = [[seen[j * layers + i] for j in range(shards)] for i in range(layers)]
    return ([sum(c[0] for c in calls) for calls in at], sum(c[1] for c in at[0]),
            [torch.cat([c[2] for c in calls]) for calls in at])


def _moe_layer_same_input(sess, moe_params, cfg, shape: tuple, dtype) -> tuple:
    """Layer 0's MoE on one input, tensor-parallel (``_tp_moe`` over the
    first position's model group) and on one device (``moe_forward`` on
    ``moe_params``, the layer's whole tree): (relative norm of the outputs,
    dropped choices of each, the choices whose expert differs). Normal
    tokens around a shared direction, which skews the routing, at the
    prefill's group size."""
    from repro_torch.distributed.tensor_parallel import model_group
    from repro_torch.models import model as model_mod
    from repro_torch.models import moe
    from repro_torch.models.params import tree_map

    gen = torch.Generator(device="cuda").manual_seed(41)
    h = torch.randn(*shape, cfg.d_model, generator=gen, device="cuda")
    h = (h + 2.0 * torch.randn(cfg.d_model, generator=gen, device="cuda")).to(dtype)
    group_size = model_mod._moe_group(h)
    seen: list = []
    real = moe.aux_metrics

    def spy(pl, c):
        seen.append(pl)
        return real(pl, c)

    moe.aux_metrics = spy
    try:
        with sess.gathered():
            group = model_group(sess._full, sess.mesh, (0,) * sess.mesh.devices.ndim)
            got, _ = model_mod._tp_moe(group, model_mod._tp_layers(group, cfg)[0], h, cfg,
                                       group_size)
        want, _ = moe.moe_forward(tree_map(lambda t: t[0], moe_params), h, cfg, group_size)
    finally:
        moe.aux_metrics = real
    tp_plan, one_plan = seen
    return (_rel(got, want), int((~tp_plan.within).sum()), int((~one_plan.within).sum()),
            int((tp_plan.experts != one_plan.experts).sum()))


@contextlib.contextmanager
def _flash_heads():
    """The (query heads, KV heads, keys, causal) of each flash launch of the
    model code, recorded in the list yielded."""
    from repro_torch.models import layers

    seen: list = []
    real = layers.flash_attention_bshd

    def spy(q, k, v, *args, **kwargs):
        seen.append((q.shape[2], k.shape[2], k.shape[1], bool(kwargs.get("causal"))))
        return real(q, k, v, *args, **kwargs)

    layers.flash_attention_bshd = spy
    try:
        yield seen
    finally:
        layers.flash_attention_bshd = real


def _image_embeds(rng, b: int, cfg) -> np.ndarray:
    """The VLM's image embeddings in 21d and ``tools/tp_drift.py``: normal
    patches around one shared direction of twice their scale, as a vision
    tower's patch embeddings share a common component. At random weights a
    cross layer attends nearly uniformly over its 1,601 keys, so the
    patches' own noise averages to about 1/40 of a token's size; the shared
    part keeps the cross layers' output, and a fault there, of a token's
    size."""
    shared = 2.0 * rng.normal(size=cfg.d_frontend)
    return (rng.normal(size=(b, cfg.n_image_tokens, cfg.d_frontend)) + shared).astype(np.float32)


def _tp_launches(cfg, m: int, plen: int, data_shards: int) -> list:
    """The flash launches of a tensor-parallel prefill, in order: (query
    heads, KV heads, keys, causal) a (data shard, attention layer, model
    shard), the VLM's cross layers non-causal over its image tokens; the
    hybrid attends once a group (its shared block), the SSM never, nor a
    config that attends by "xla" (MLA)."""
    from repro_torch.models.model import hybrid_counts, vlm_counts

    if cfg.family == "ssm" or cfg.attention_impl != "flash":
        return []
    heads = (cfg.n_heads // m, max(cfg.n_kv_heads // m, 1))
    layers = [(plen, True)] * cfg.n_layers
    if cfg.family == "vlm":
        groups, self_per, _ = vlm_counts(cfg)
        layers = ([(plen, True)] * self_per + [(cfg.n_image_tokens, False)]) * groups
    if cfg.family == "hybrid":
        layers = [(plen, True)] * hybrid_counts(cfg)[0]
    return [(*heads, sk, causal) for _ in range(data_shards) for sk, causal in layers
            for _ in range(m)]


@contextlib.contextmanager
def _patched(module, attr: str, make):
    """``module.attr`` replaced by ``make(real)`` inside the block."""
    real = getattr(module, attr)
    setattr(module, attr, make(real))
    try:
        yield
    finally:
        setattr(module, attr, real)


@contextlib.contextmanager
def _neighbour_image_heads():
    """A planted fault: in the VLM's cross layers only (``_tp_cross`` at
    the prefill, ``_tp_cross_decode`` at decode), each model shard takes its
    neighbour's KV heads of the image K/V; the self layers keep theirs."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.models import model as model_mod

    def crossing(fn):
        def wrapped(*args, **kwargs):
            with _patched(tensor_parallel, "kv_block",
                          lambda real: lambda c, j, m: real(c, (j + 1) % m, m)):
                return fn(*args, **kwargs)

        return wrapped

    with _patched(model_mod, "_tp_cross", crossing), \
            _patched(model_mod, "_tp_cross_decode", crossing):
        yield


def _neighbour_latent_heads():
    """A planted fault: at decode each model shard receives its neighbour's
    heads of an MLA layer's combined latent (``mla_head_range`` patched in
    ``_tp_mla_decode`` only), which it takes through its own wuv columns and
    rows of wo."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.models import model as model_mod

    def crossing(fn):
        def wrapped(*args, **kwargs):
            with _patched(tensor_parallel, "mla_head_range",
                          lambda real: lambda c, j, m: real(c, (j + 1) % m, m)):
                return fn(*args, **kwargs)

        return wrapped

    return _patched(model_mod, "_tp_mla_decode", crossing)


def _neighbour_state():
    """A planted fault: at decode each model shard reads its neighbour's
    head block of a mamba layer's ``ssm`` state (from the neighbour's mesh
    position); its conv states stay its own."""
    from repro_torch.models import model as model_mod

    return _patched(model_mod, "_tp_state_views", lambda real: lambda group, j, *a: {
        **real(group, j, *a), "ssm": real(group, (j + 1) % group.m, *a)["ssm"]})


@contextlib.contextmanager
def _neighbour_heads():
    """A planted fault: in ``_tp_attention`` each model shard takes its
    neighbour's K/V heads for its own queries (``head_range`` shifted for
    ``kv_block``), its projections and rows of wo its own."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.models import model as model_mod

    def crossing(fn):
        def wrapped(*args, **kwargs):
            with _patched(tensor_parallel, "head_range",
                          lambda real: lambda c, j, m: real(c, (j + 1) % m, m)):
                return fn(*args, **kwargs)

        return wrapped

    with _patched(model_mod, "_tp_attention", crossing):
        yield


def _audio_frames(rng, cfg) -> np.ndarray:
    """The audio runs' frames ``[B, S, d_frontend]`` (21d and
    ``tools/tp_drift.py``): normal frames around one shared direction of
    twice their scale, as a recording's frames share its channel's
    component. At random weights each head attends over the 512 frames
    nearly evenly, so independent frames' values average to about 1/20 of
    a frame's; the shared part keeps the attention's output, and a fault in
    it, of a frame's size."""
    b, s = AUDIO_TP_SHAPE
    shared = 2.0 * rng.normal(size=cfg.d_frontend)
    return (rng.normal(size=(b, s, cfg.d_frontend)) + shared).astype(np.float32)


def _audio_one_device(cfg, params, frames: torch.Tensor) -> tuple:
    """One device's (last logits, full-frame logits, prefill s) of the audio
    encoder: ``make_prefill_step(cfg)``, timed on its second call, and
    ``forward_train``."""
    from repro_torch.launch.steps import make_forward_step, make_prefill_step

    step = make_prefill_step(cfg)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, _ = step(params, {}, {"frames": frames})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return last, make_forward_step(cfg)(params, {"frames": frames}), secs


def _tp_bytes_text(arch: str, tp_bytes: dict, whole: int) -> str:
    """21d's bytes rule, no position gathering ``SERVE_TP_BYTES_SHARE`` of
    the tree (``whole`` bytes), checked; the log's text of it."""
    check(all(v < SERVE_TP_BYTES_SHARE * whole for v in tp_bytes.values()),
          f"[tp serve] {arch}: a position gathered {tp_bytes} of {whole}")
    return (f"bytes each position gathered for a step: tensor-parallel "
            f"{sorted(set(tp_bytes.values()))} (its 'model' blocks), the gathered path {whole} "
            f"(every parameter), ratio {max(tp_bytes.values()) / whole:.4f}")


def _check_tp_heads(arch: str, pre: dict, heads: list, want_heads: list, also: bool = True,
                    more: str = "") -> None:
    """A 21d prefill launched flash ``want_heads`` in order (``_flash_heads``'
    readings) and no other kernel; ``also`` is the caller's own condition,
    ``more`` its text."""
    check(also and pre["flash_attention"] == len(want_heads) and heads == want_heads
          and not any(v for k, v in pre.items() if k != "flash_attention"),
          f"[tp serve] {arch}: launches prefill {pre}{more}, (heads, KV heads, keys, causal) "
          f"{sorted(set(heads))}; expected {len(want_heads)} flash, {sorted(set(want_heads))}")


def _tp_kernel_cases(arch: str, cfg, rows: int, sq: int, heads: list, dtype: str) -> dict:
    """The flash kernel at each of a 21d prefill's shapes (a data shard's
    rows, the model shard's query and KV heads), held to its plain version:
    label -> (Sk, causal, max |err|, max row error, tiles scored). A
    non-causal launch of a causal model is the VLM's cross attention
    (queries at 0 .., key positions zero), of the encoder its self
    attention."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bshd_cuda,
        flash_attention_bshd_reference,
    )

    kernel = {}
    for hq, hk, sk, causal in sorted(set(heads), key=lambda t: not t[3]):
        cross = cfg.causal and not causal
        ops = _gqa_inputs(rows, sq, sk, hq, hk, cfg.resolved_head_dim, getattr(torch, dtype),
                          seed=31 if causal else 32 if cross else 33)
        if cross:  # attn_forward's cross branch: queries at 0 .., keys at 0
            ops = (*ops[:3], torch.arange(sq, dtype=torch.int32, device="cuda").repeat(rows, 1),
                   torch.zeros_like(ops[4]))
        label = "cross" if cross else "self"
        kernel[label] = (sk, causal, *_flash_case(
            flash_attention_bshd_cuda, flash_attention_bshd_reference, ops, causal, hq,
            f"{arch} tensor-parallel prefill shard, {label} attention"))
        del ops
    return kernel


def _kernel_text(kernel: dict, rows: int, sq: int) -> str:
    return "; ".join(f"{label} attention (B {rows}, Sq {sq}, Sk {sk}, "
                     f"{'causal' if causal else 'not causal'}) max |err| {err:.3e}, max row "
                     f"error {row:.3e}, {tiles} tiles scored"
                     for label, (sk, causal, err, row, tiles) in kernel.items()) or "none run"


def _dropped_partial():
    """A planted fault of every 21d run: a reduction that loses the last
    model shard's partial."""
    from repro_torch.distributed import tensor_parallel

    return _patched(tensor_parallel, "reduce_f32",
                    lambda real: lambda parts, dev, dt: real(parts[:-1], dev, dt))


def _faults_refused(arch: str, faults: dict, verdict) -> dict:
    """Each planted fault (name -> context) under ``verdict()`` (passes,
    readings, text), which must refuse it: name -> its readings."""
    refused = {}
    for name, planted in faults.items():
        with planted():
            bad_ok, bad, _ = verdict()
        check(not bad_ok, f"[tp serve] {arch}: {name} passes the rule: {bad}")
        refused[name] = bad
    return refused


def _refused_text(refused: dict, tol: float) -> str:
    return "; ".join(f"{name} {[round(r, 6) for r in bad]}, {max(bad) / tol:.1f} x the bound"
                     for name, bad in refused.items())


def _tensor_parallel_audio_run(arch: str, depth: int, dtype: str, mesh, smi: str, rng) -> int:
    """One audio config of 21d: ``ServeSession`` refuses the encoder, so its
    prefill step on the mesh (``make_prefill_step(cfg, mesh)``) against one
    device's (``make_prefill_step(cfg)``), and its full-frame logits
    (``make_forward_step(cfg, mesh)``: ``forward_tp``) against one device's
    ``forward_train``. Returns the flash launches of its prefill."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.tensor_parallel import ModelBlocks, serves_tensor_parallel
    from repro_torch.launch.steps import (
        gather_params,
        make_forward_step,
        make_prefill_step,
        place_params,
    )
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_leaves, tree_map

    full_cfg = get_config(arch)
    impl = SERVE_SHARD_IMPL.get(arch, "flash")
    cfg = full_cfg.scaled(n_layers=depth, dtype=dtype, attention_impl=impl)
    check(serves_tensor_parallel(cfg, mesh), f"[tp serve] {arch} does not take the TP path")
    frames = torch.from_numpy(_audio_frames(rng, cfg)).cuda()
    b, s = AUDIO_TP_SHAPE
    vocab = cfg.vocab
    torch.cuda.empty_cache()
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    one_last, one_full, one_s = _audio_one_device(cfg, params, frames)
    exact = None
    if dtype == "bfloat16":  # the same weights in float32
        f32 = tree_map(lambda t: t.float(), params)
        exact = _audio_one_device(cfg.scaled(dtype="float32"), f32, frames)[:2]
        del f32
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    placed = place_params(cfg, mesh, params)
    del params
    torch.cuda.empty_cache()
    blocks = gather_params(placed, mesh, cfg)
    check(isinstance(blocks, ModelBlocks), f"[tp serve] {arch}: gathered {type(blocks)}")
    bytes_text = _tp_bytes_text(arch, dict(blocks.bytes_by_position), whole)
    m = mesh.devices.shape[-1]
    data_shards = _prefill_shards(cfg, mesh, b, s)
    step, forward = make_prefill_step(cfg, mesh), make_forward_step(cfg, mesh)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):  # the first run meets the column blocks' shapes first
        with _flash_heads() as heads:
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            last, cache = step(blocks, {}, {"frames": frames})
            torch.cuda.synchronize()
            runs.append((last, _launches(), time.perf_counter() - t0, list(heads)))
    peak = torch.cuda.max_memory_allocated()
    last, pre, prefill_s, heads = runs[-1]
    full = forward(blocks, {"frames": frames})
    want_heads = [(cfg.n_heads // m, cfg.n_kv_heads // m, s, cfg.causal)] * (
        data_shards * depth * m)
    _check_tp_heads(arch, pre, heads, want_heads, also=cache == {}, more=f", cache {cache}")
    rows = b // data_shards
    hq, hk, sk, _ = want_heads[0]
    kernel = _tp_kernel_cases(arch, cfg, rows, s, heads, dtype)
    tol = SERVE_TP_BF16_TOL.get(arch, SERVE_SHARD_TOL) if exact is not None else FAMILY_CARD_TOL

    def verdict(got_last, got_full) -> tuple:
        """The run's rule: (passes, relative norms of the last and the
        full-frame logits against one device, the text of the float32
        comparison). In bf16 also finite and no farther from the float32 run
        than one device is, plus LM_TOL."""
        rels = [_rel(got_last[:, :vocab], one_last[:, :vocab]),
                _rel(got_full[..., :vocab], one_full[..., :vocab])]
        if exact is None:
            return max(rels) <= tol, rels, ""
        one_f32 = max(_rel(o[..., :vocab], e[..., :vocab])
                      for o, e in zip((one_last, one_full), exact))
        tp_f32 = max(_rel(o[..., :vocab], e[..., :vocab])
                     for o, e in zip((got_last, got_full), exact))
        finite = bool(torch.isfinite(got_last[:, :vocab]).all()
                      and torch.isfinite(got_full[..., :vocab]).all())
        return (finite and max(rels) <= tol and tp_f32 <= one_f32 + LM_TOL, rels,
                f"; against a float32 run of the same weights, max of the two: one device "
                f"{one_f32:.6f}, tensor-parallel {tp_f32:.6f} (bound one device + {LM_TOL})")

    ok, rels, against_f32 = verdict(last, full)
    check(ok, f"[tp serve] {arch} {dtype}: tensor-parallel vs one device relative norms (last, "
              f"full-frame) {rels} (bound {tol}){against_f32}")
    refused = _faults_refused(arch, {"a reduction dropping the last shard's partial": _dropped_partial,
                              "a shard attending to its neighbour's K/V heads": _neighbour_heads},
                       lambda: verdict(step(blocks, {}, {"frames": frames})[0],
                                       forward(blocks, {"frames": frames})))
    log(f"[tp serve] {arch} ({cfg.family}, profile 'tp') at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, KV {cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"frames of {cfg.d_frontend}, vocab {vocab}, not causal), {depth} of {full_cfg.n_layers} "
        f"layers, {dtype}, attention {impl!r}, tensor-parallel on {SERVE_TP_MESH} logical shards "
        f"of {SHARD_DEVICE}: the prefill step on {b} x {s} frames (seeded, around a shared "
        f"direction) against one device's: last logits relative norm {rels[0]:.3e}, "
        f"forward_tp's full-frame logits against forward_train {rels[1]:.3e} (bound "
        f"{tol}){against_f32}; {bytes_text}; flash launches prefill "
        f"{pre['flash_attention']} ({depth} attention layers x {data_shards} data shards x {m} "
        f"model shards, each on {hq} query and {hk} KV heads, Sk {sk}, not causal; one device "
        f"{depth} on {cfg.n_heads}); the kernel at the path's shape against its plain version: "
        f"{_kernel_text(kernel, rows, s)}; prefill {prefill_s:.6f} s (first run "
        f"{runs[0][2]:.6f}; one device {one_s:.6f}); max_memory_allocated {peak} bytes (the "
        f"placed and the gathered blocks on one card: logical shards share its memory); refused "
        f"by the same rule: {_refused_text(refused, tol)}; {smi}")
    del blocks, placed, runs, last, full
    return pre["flash_attention"]


def _tp_inputs(cfg, dtype: str, rng) -> tuple:
    """A 21d run's (batch, prompt, generated) and its prompts and image
    embeddings (the VLM's; else None), drawn from the phase's ``rng``."""
    b, plen, gen = ((FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN) if dtype == "bfloat16"
                    else SERVE_SHARD_F32_MOE_SHAPE if cfg.family == "moe"
                    else SERVE_SHARD_F32_SHAPE)
    prompts = rng.integers(0, cfg.vocab, (b, plen), dtype=np.int32)
    return (b, plen, gen), prompts, _image_embeds(rng, b, cfg) if cfg.family == "vlm" else None


def _tensor_parallel_run(arch: str, depth: int, dtype: str, mesh, smi: str, rng) -> int:
    """One config of 21d: the one-device session's tokens, then the
    tensor-parallel session teacher-forced on them. Returns the flash
    launches of its prefill."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.tensor_parallel import ModelBlocks, serves_tensor_parallel
    from repro_torch.distributed import tensor_parallel
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.model import hybrid_counts, init_model, vlm_counts
    from repro_torch.models.params import tree_leaves, tree_map

    full = get_config(arch)
    impl = SERVE_SHARD_IMPL.get(arch, "flash")
    cfg = full.scaled(n_layers=depth, dtype=dtype, attention_impl=impl)
    check(serves_tensor_parallel(cfg, mesh), f"[tp serve] {arch} does not take the TP path")
    moe, vlm, mla = cfg.family == "moe", cfg.family == "vlm", cfg.attention == "mla"
    ssm = cfg.family in ("ssm", "hybrid")
    (b, plen, gen), prompts, img = _tp_inputs(cfg, dtype, rng)
    torch.cuda.empty_cache()
    gen_card = torch.Generator(device="cuda").manual_seed(0)
    params = init_model(gen_card, cfg, "cuda")
    _open_gates(params)
    _passing_conv(params)
    _sharp_mla(params, cfg)
    if cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            params["layers"]["attn"][name].normal_(0.0, SERVE_TP_BIAS_STD, generator=gen_card)
    common = dict(batch=b, max_seq=plen + gen, attention_impl=impl, n_layers=depth)
    one = ServeSession(arch, params=params, dtype=dtype, **common)
    tokens, stats = one.generate(prompts, gen, image_embeds=img, keep_logits=True)
    forced = tokens[:, plen:]
    _, one_pre, _, one_prefill_s, one_decode_s, _ = _forced(one, prompts, img, forced)
    one_routing = _prefill_routing(one, prompts) if moe else None
    # The float32 rule holds each step to the one-device session's, which
    # is computed here so that its parameters are freed before the mesh
    # session places and gathers its copies; in bf16 its logits are kept.
    one_steps = _one_device_steps(one, prompts, img, forced) if dtype == "float32" else None
    del one
    exact = None
    if dtype == "bfloat16":  # the same weights in float32, fed the same tokens
        f32 = ServeSession(arch, params=tree_map(lambda t: t.float(), params), dtype="float32",
                           **common)
        exact = _forced(f32, prompts, img, forced)[0]
        del f32
        torch.cuda.empty_cache()
    sess = ServeSession(arch, mesh=mesh, params=params, dtype=dtype, **common)
    same = None
    if moe:  # the layer on one input: its routing and drops are one device's exactly
        same = _moe_layer_same_input(sess, params["layers"]["moe"], cfg, (b, plen),
                                     getattr(torch, dtype))
        check(same[0] <= (FAMILY_CARD_TOL if dtype == "float32" else MOE_LAYER_BF16_TOL)
              and same[1] == same[2] and same[3] == 0,
              f"[tp serve] {arch} {dtype}: layer 0's MoE on one input, tensor-parallel vs one "
              f"device: relative norm {same[0]}, dropped {same[1]} / {same[2]}, {same[3]} "
              f"choices routed elsewhere")
    del params  # the session holds its own blocks
    torch.cuda.empty_cache()
    # What the gathered path gives each position: every parameter, whole.
    whole = sum(t.shape.numel() * t.dtype.itemsize for t in tree_leaves(sess.params))
    with sess.gathered():  # the blocks are freed on the way out
        check(isinstance(sess._full, ModelBlocks), f"[tp serve] {arch}: gathered "
              f"{type(sess._full)}")
        tp_bytes = dict(sess._full.bytes_by_position)
    m = mesh.devices.shape[-1]
    shards = _prefill_shards(cfg, mesh, b, plen) * m
    bytes_text = _tp_bytes_text(arch, tp_bytes, whole)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):  # the first run's steps meet the column blocks' shapes first
        with _flash_heads() as heads:
            runs.append((*_forced(sess, prompts, img, forced), list(heads)))
    peak = torch.cuda.max_memory_allocated()
    got, pre, dec, prefill_s, decode_s, layout, heads = runs[-1]
    want_heads = _tp_launches(cfg, m, plen, shards // m)
    _check_tp_heads(arch, pre, heads, want_heads, also=not any(dec.values()),
                    more=f", decode {dec}")
    rows = b // (shards // m)
    kernel = _tp_kernel_cases(arch, cfg, rows, plen, heads, dtype)
    rels = _step_rels(got, stats["logits"], cfg.vocab)
    tol = SERVE_TP_BF16_TOL.get(arch, SERVE_SHARD_TOL) if exact is not None else FAMILY_CARD_TOL
    drops, held = "", None
    if moe:  # the prefill's routing and drops, layer by layer, against one device's
        tp_drops, choices, tp_experts = _prefill_routing(sess, prompts)
        one_drops, _, one_experts = one_routing
        moved = [(a != e).flatten(1).sum(1) for a, e in zip(tp_experts, one_experts)]
        flips = [int(t.sum()) for t in moved]
        per_group = tp_experts[0].shape[1] // plen  # a routing group's batch rows
        parted = sorted({g * per_group + r for t in moved for g in t.nonzero().flatten().tolist()
                         for r in range(per_group)})
        held = [r for r in range(b) if r not in parted]
        first = next((f for f in flips if f), 0)
        # In float32 a layer's input differs from one device's by the
        # reductions' order, which can move a choice between two experts
        # whose probabilities tie to that rounding: a moved choice changes
        # the drops by one at most, and in its routing group it moves other
        # tokens past the capacity, which parts that group's later layers
        # and logits. The layer on one input is exact above; the prefill's
        # logits are held on the rows of the groups that route as one
        # device's (at least one), its drops by the moved choices.
        check(exact is not None or (
            all(abs(t - o) <= f for t, o, f in zip(tp_drops, one_drops, flips))
            and first <= MOE_FLIP_TOL * choices and held),
              f"[tp serve] {arch} float32: dropped choices a layer {tp_drops} of {choices}, "
              f"one device {one_drops}; choices routed elsewhere {flips}, rows parted {parted}")
        drops = (f"; the prefill's dropped choices a layer {tp_drops} of {choices} (dropped "
                 f"fraction {sum(tp_drops) / (choices * depth):.6f}; one device {one_drops}; "
                 f"choices routed to another expert than one device's {flips}, in the routing "
                 f"groups of rows {parted}); layer 0's MoE on one {b} x {plen} input against one "
                 f"device's: relative norm {same[0]:.3e}, dropped {same[1]} and {same[2]}, "
                 f"{same[3]} choices routed elsewhere")
        if exact is not None:
            held = None
    margin = SERVE_TP_F32_MARGIN.get(arch, LM_TOL)

    def verdict(steps: int) -> tuple:
        """The run's rule over its first ``steps`` steps: (passes, relative
        norms against one device, the text of the float32 comparison). In
        bf16: finite logits within ``tol`` of one device, and no farther
        from the float32 run than one device is, plus LM_TOL. In float32 a
        decode step reads the bf16 attention caches (bf16 whatever the
        dtype), whose rounding of the two paths' float32 K/V may part by one
        bf16 step, and the parted entries add up over the steps: each step
        is held within ``tol`` from a copy of the one-device session's
        cache (the MoE's prefill on the rows ``held``)."""
        if exact is None:
            same = _same_cache_steps(one_steps, sess, prompts, img, forced[:, :steps], held)
            rows = "" if held is None else f"; the prefill on rows {held}"
            return (max(same) <= tol, same,
                    f"; each step from a copy of the one-device session's cache "
                    f"{[float(f'{r:.3e}') for r in same]} (bound {tol}{rows}; the steps above "
                    f"read their own caches)")
        logits = got if steps == gen else _forced(sess, prompts, img, forced[:, :steps])[0]
        near = _step_rels(logits, stats["logits"][:steps], cfg.vocab)
        one_f32 = max(_step_rels(torch.as_tensor(stats["logits"][:steps]), exact[:steps],
                                 cfg.vocab))
        tp_f32 = max(_step_rels(logits, exact[:steps], cfg.vocab))
        return (bool(torch.isfinite(logits[..., :cfg.vocab]).all()) and max(near) <= tol
                and tp_f32 <= one_f32 + margin, near,
                f"; against a float32 run of the same weights, max over the steps: one device "
                f"{one_f32:.6f}, tensor-parallel {tp_f32:.6f} (bound one device + {margin:.6f})")

    ok, _, against_f32 = verdict(gen)
    check(bool(torch.isfinite(got[..., :cfg.vocab]).all()) and ok,
          f"[tp serve] {arch} {dtype}: tensor-parallel vs one device relative norms {rels} "
          f"(bound {tol}){against_f32}")
    # Planted faults the rule must refuse, each held by the same verdict
    # over two steps: a reduction that loses the last model shard's
    # partial; for the MoE, a shard that builds its neighbour's expert
    # block's one-hots and runs them on its own weights; for the VLM, a
    # shard that takes its neighbour's KV heads of the image K/V in the
    # cross layers only.
    faults = {"a reduction dropping the last shard's partial": _dropped_partial}
    if moe:
        faults["a shard running its neighbour's expert block"] = lambda: _patched(
            tensor_parallel, "expert_range", lambda real: lambda c, j, m_: real(c, (j + 1) % m_,
                                                                               m_))
    if vlm:
        faults["a shard taking its neighbour's KV heads of the image K/V"] = _neighbour_image_heads
    if ssm:
        faults["a shard reading its neighbour's head block of the SSM state"] = _neighbour_state
    if mla:
        faults["a shard receiving its neighbour's heads of the combined latent"] = (
            _neighbour_latent_heads)
    refused = _faults_refused(arch, faults, lambda: verdict(2))
    cut = f"{depth} of {full.n_layers} layers"
    first = runs[0]
    experts = (f", {cfg.n_experts} experts top-{cfg.experts_per_token} ({cfg.n_experts // m} a "
               f"shard), capacity factor {cfg.moe_capacity_factor}") if moe else ""
    if vlm:
        groups, self_per, _ = vlm_counts(cfg)
        experts = (f", {cfg.n_image_tokens} image tokens of width {cfg.d_frontend} (seeded), "
                   f"{groups} groups of {self_per} self and 1 cross layer, cross gates "
                   f"{FAMILY_GATE}")
    attn = (f"{cfg.n_heads} heads, KV {cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, d_ff "
            f"{cfg.d_ff}, " if cfg.n_heads else "")
    if mla:
        from repro_torch.distributed.tensor_parallel import mla_head_range

        per = sorted({h1 - h0 for h0, h1 in (mla_head_range(cfg, j, m) for j in range(m))})
        attn = (f"{cfg.n_heads} MLA heads ({' or '.join(map(str, per))} a shard; q/k "
                f"{cfg.qk_nope_dim} + {cfg.qk_rope_dim}, v {cfg.v_head_dim}, latent ranks "
                f"{cfg.q_lora_rank} and {cfg.kv_lora_rank}; q_norm scaled so that the latent "
                f"scores spread about {MLA_SCORE_STD}), d_ff {cfg.d_ff}, ")
    if ssm:
        groups, trailing = hybrid_counts(cfg) if cfg.family == "hybrid" else (0, cfg.n_layers)
        experts = (f", {cfg.ssm_heads} SSM heads ({cfg.ssm_heads // m} a shard) of "
                   f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, {cfg.ssm_groups} B/C group, "
                   f"chunk {cfg.ssm_chunk}, conv taps passing their input"
                   + (f", {groups} groups of {cfg.hybrid_attn_every} mamba layers and the shared "
                      f"block, {trailing} trailing" if groups else ""))
    if mla:
        launched = (f"{pre['flash_attention']} (attention {impl!r}: MLA's values are narrower "
                    f"than its queries; one device {one_pre['flash_attention']})")
    elif heads:
        launched = (f"{pre['flash_attention']} ({len(want_heads) // (shards // m * m)} attention "
                    f"layers x {shards // m} data shards x {m} model shards, each on "
                    f"{heads[0][0]} query and {heads[0][1]} KV heads; one device "
                    f"{one_pre['flash_attention']} on {cfg.n_heads})")
    else:
        launched = (f"{pre['flash_attention']} (no attention layer; one device "
                    f"{one_pre['flash_attention']})")
    log(f"[tp serve] {arch} ({cfg.family}, profile 'tp') at full width (d_model {cfg.d_model}, "
        f"{attn}vocab {cfg.vocab}{experts}), {cut}, {dtype}, attention {impl!r}, tensor-parallel on "
        f"{SERVE_TP_MESH} logical shards of {SHARD_DEVICE}"
        + (f", QKV biases drawn at std {SERVE_TP_BIAS_STD}" if cfg.qkv_bias else "")
        + f": {b} x {plen} prompt tokens, {gen} steps teacher-forced on the one-device session's "
        f"tokens: logits relative norm prefill {rels[0]:.3e}, decode max {max(rels[1:]):.3e} "
        f"(each {[float(f'{r:.3e}') for r in rels]}; bound {tol}){against_f32}{drops}; "
        f"{bytes_text}; flash launches prefill {launched}, decode {dec['flash_attention']}; the "
        f"kernel at the path's shapes against its plain version: "
        f"{_kernel_text(kernel, rows, plen)}; prefill {prefill_s:.6f} s (first run {first[3]:.6f}; one device {one_prefill_s:.6f}), decode "
        f"{1e3 * decode_s / (gen - 1):.3f} ms a step (first run "
        f"{1e3 * first[4] / (gen - 1):.3f}; one device {1e3 * one_decode_s / (gen - 1):.3f}); "
        f"max_memory_allocated {peak} bytes (the placed and the gathered blocks on one card: "
        f"logical shards share its memory); refused by the same rule: "
        f"{_refused_text(refused, tol)}; cache specs {layout}; {smi}")
    del sess, got, runs
    return pre["flash_attention"]


def phase_tensor_parallel_serve() -> dict:
    """21d: the decoders served tensor-parallel on 2 x 2 logical shards of
    the card (the module docstring). Returns the flash launches of each
    run's prefill."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    mesh = _logical_mesh(SERVE_TP_MESH)
    rng = np.random.default_rng(SERVE_TP_SEED)
    flash = {}
    from repro_torch.configs import get_config

    for arch, depth, dtype in SERVE_TP_RUNS:
        t0 = time.perf_counter()
        run = _tensor_parallel_audio_run if get_config(arch).family == "audio" else (
            _tensor_parallel_run)
        flash[f"tensor_parallel_serve:{arch}:{dtype}"] = run(arch, depth, dtype, mesh, smi, rng)
        log(f"[tp serve] {arch} {dtype} took {time.perf_counter() - t0:.3f} s")
    torch.cuda.empty_cache()
    log(f"[tp serve] phase 21d took {time.perf_counter() - t_phase:.3f} s")
    return flash


# ---------------------------------------------------------------- phase 22


def _start_host_child(kind: str) -> tuple:
    """Start ``_host_child(kind)`` in its own session (so that its forked
    oracle workers can be stopped with it), with no card visible. Returns
    (process, working directory, start time)."""
    import atexit
    import shutil
    import signal
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_host_"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    with open(work / "child.log", "w") as out:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), HOST_CHILD_FLAG,
                                 kind, str(work)],
                                env=env, stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)

    atexit.register(stop)
    return proc, work, time.perf_counter()


def _write_json(path: Path, obj: dict) -> None:
    """Write ``obj`` so that a reader polling for ``path`` sees it whole."""
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(obj))
    tmp.rename(path)


def _child_result(child: tuple, name: str, timeout: float) -> dict:
    """The host child's ``name`` once written; fails if the child exits
    without it or ``timeout`` seconds pass."""
    proc, work, _ = child
    deadline = time.perf_counter() + timeout
    while not (work / name).exists():
        rc = proc.poll()
        check(rc is None and time.perf_counter() < deadline,
              f"host child exited {rc} or took {timeout} s without {name}: "
              f"{(work / 'child.log').read_text()[-4000:]}")
        time.sleep(0.5)
    return json.loads((work / name).read_text())


def _cpu_path_count(edges: np.ndarray, **kwargs) -> dict:
    """``tcim_count(edges, device="cpu", **kwargs)``: the port's CPU path
    (the host build and the kernels' plain versions), as phases 4 and 9
    hold the card to it."""
    from repro_torch.core import tcim_count

    t0 = time.perf_counter()
    res = tcim_count(edges, device="cpu", **kwargs)
    return {"triangles": res.triangles, "build": res.stats.get("build"), "m": len(edges),
            "num_pairs": res.stats.get("num_pairs"), "nvs": res.stats.get("nvs"),
            "timings_s": res.timings_s, "wall": time.perf_counter() - t0}


def _background() -> None:
    """Put this host child, and the processes it forks after, at the lowest
    priority (nice 19), so that the card's phases keep their host cores.
    (The card's machine refuses SCHED_IDLE.)"""
    os.nice(19 - os.nice(0))


def _host_child(kind: str, work: Path) -> int:
    """The host's work of the card's phases, in child processes beside
    them (``kind``): "cpu-paths" counts com-youtube through the port's CPU
    path (``main.json``, phase 4), runs its host build (``host_build.npz``,
    phase 4b), counts ego-facebook through the dense backends' CPU paths
    (``dense.json``, phase 9), on CPU_PATH_THREADS torch threads, then the
    families' train steps on meta tensors (``costs.json``, phase 18c);
    "oracles" runs NumPy only, so that it may fork (``_oracles``). What
    phase 9 and phase 4 need runs at nice 10, what later phases need runs
    in the background (``_background``: nice 19)."""
    from repro_torch.configs import GRAPHS

    os.nice(10)
    if kind == "cpu-paths":
        from repro_torch.core.sbf import build_sbf, build_worklist
        from repro_torch.graphs import build_graph

        torch.set_num_threads(CPU_PATH_THREADS)
        edges = _edges(GRAPHS[MAIN_GRAPH])
        _write_json(work / "main.json", _cpu_path_count(edges, slice_bits=MAIN_SLICE_BITS))
        g = build_graph(edges, reorder=True)
        t0 = time.perf_counter()
        sb = build_sbf(g, MAIN_SLICE_BITS)
        wl = build_worklist(g, sb)
        host_s = time.perf_counter() - t0
        np.savez(work / "host_build_tmp.npz", **{f: getattr(sb, f) for f in HOST_SBF_FIELDS},
                 **{f: getattr(wl, f) for f in HOST_WORKLIST_FIELDS})
        (work / "host_build_tmp.npz").rename(work / "host_build.npz")
        _write_json(work / "host_build.json", {"s": host_s, "m": len(edges)})
        del g, sb, wl
        edges = _edges(GRAPHS["ego-facebook"])
        _write_json(work / "dense.json", {b: _cpu_path_count(edges, backend=b)
                                          for b in DENSE_BACKENDS})
        _background()
        _write_json(work / "costs.json", {arch: _family_counted(_family_loop_cfg(arch, depth)[1])
                                          for arch, depth in FAMILY_TRAIN_LOOPS})
        return 0
    check(kind == "oracles", f"host child kind {kind!r}")
    return _oracles(work)


def _oracles(work: Path) -> int:
    """Phases 4 and 22's host work. First com-youtube's exact count
    (``main.json``); then, in the background, com-livejournal in two
    processes: this one makes the graph scaled by LJ_LIMIT_SCALE (saved)
    and its exact count (``lj_scaled.json``), a forked one the full graph
    from its config and seed (saved for the card) and the host build's
    orient and SBF at LJ_SLICE_BITS with their valid slices a side and
    candidate totals (``lj_full.json``). Every exact count is
    ``triangles_intersection`` over LJ_ORACLE_WORKERS forked processes."""
    import multiprocessing

    from repro_torch.configs import GRAPHS
    from repro_torch.graphs import build_graph
    from tools.livejournal_count import triangles_forked

    edges = _edges(GRAPHS[MAIN_GRAPH])
    t0 = time.perf_counter()
    exact = triangles_forked(build_graph(edges, reorder=True), LJ_ORACLE_WORKERS)
    _write_json(work / "main.json", {"exact": exact, "m": len(edges),
                                     "oracle_s": time.perf_counter() - t0})
    _background()
    full = multiprocessing.get_context("fork").Process(target=_lj_full, args=(work,))
    full.start()
    cfg = GRAPHS[LJ_GRAPH].scaled(LJ_LIMIT_SCALE)
    t0 = time.perf_counter()
    scaled = _edges(cfg)
    out = {"n": cfg.n, "m": len(scaled), "gen_s": time.perf_counter() - t0}
    np.save(work / "scaled.npy", scaled)
    t0 = time.perf_counter()
    out["exact"] = triangles_forked(build_graph(scaled, reorder=True), LJ_ORACLE_WORKERS)
    out["oracle_s"] = time.perf_counter() - t0
    _write_json(work / "lj_scaled.json", out)
    print(json.dumps(out), flush=True)
    full.join()
    check(full.exitcode == 0, f"the full graph's process exited {full.exitcode}")
    return 0


def _lj_full(work: Path) -> None:
    """``_oracles``'s forked half: com-livejournal at full size (saved),
    its host orient and SBF at LJ_SLICE_BITS (``lj_full.json``)."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core.sbf import build_sbf
    from repro_torch.graphs import build_graph

    out: dict = {"sides": {}}
    t0 = time.perf_counter()
    edges = _edges(GRAPHS[LJ_GRAPH])
    out["gen_s"] = time.perf_counter() - t0
    out["m"] = len(edges)
    np.save(work / "edges.npy", edges)
    t0 = time.perf_counter()
    g = build_graph(edges, reorder=True)
    out["orient_s"] = time.perf_counter() - t0
    out["max_out_degree"] = int(np.diff(g.indptr).max())
    del edges
    u = g.edges[:, 0]
    for bits in LJ_SLICE_BITS:
        t0 = time.perf_counter()
        sb = build_sbf(g, bits)
        out["sides"][str(bits)] = {
            "row_valid": len(sb.row_slice_idx), "col_valid": len(sb.col_slice_idx),
            "candidates": int((sb.row_ptr[u + 1] - sb.row_ptr[u]).sum(dtype=np.int64)),
            "compress_s": time.perf_counter() - t0}
        del sb
        print(f"slice_bits {bits}: {out['sides'][str(bits)]}", flush=True)
    _write_json(work / "lj_full.json", out)


def _refused(fn) -> tuple[str, float]:
    """(the ValueError's message, seconds until it was raised) of ``fn()``,
    which must raise the device build's documented refusal."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fn()
    except ValueError as e:
        torch.cuda.synchronize()
        return str(e), time.perf_counter() - t0
    raise RuntimeError("chip_smoke check failed: the device build took a total past its limit")


def phase_livejournal(child: tuple) -> dict:
    """22: com-livejournal on the card (see the module docstring). Returns
    the scaled count's launches of gather_total and its figures."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import build as build_mod
    from repro_torch.core import device_build_async, tcim_count
    from repro_torch.core.plan import clamp_chunk_pairs, pow2_ceil
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    limit = build_mod._CAND_GUARD  # 2**30: the largest bucket the device build takes
    proc, work, started = child
    _host_children_done((child,), "[livejournal]")  # phase 18c waited for it already
    host = _child_result(child, "lj_full.json", 0)
    small = _child_result(child, "lj_scaled.json", 0)
    cfg = GRAPHS[LJ_GRAPH]
    log(f"[livejournal] host child (in the background, nice 19): {cfg.name} |V|={cfg.n} "
        f"|E|={host['m']} generated in {host['gen_s']:.2f} s, host orient (build_graph, reorder) "
        f"{host['orient_s']:.2f} s, largest oriented out-degree {host['max_out_degree']}; scaled "
        f"x{LJ_LIMIT_SCALE} generated in {small['gen_s']:.2f} s, its exact count in "
        f"{small['oracle_s']:.2f} s over {LJ_ORACLE_WORKERS} processes")
    edges = np.load(work / "edges.npy")
    check(len(edges) == host["m"], "[livejournal] the saved edges")
    out = {}
    for bits in LJ_SLICE_BITS:
        want = host["sides"][str(bits)]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        msg, refused_s = _refused(lambda: tcim_count(edges, backend="pallas_total", build="device",
                                                    slice_bits=bits))
        peak = torch.cuda.max_memory_allocated()
        check("at or past int32 device indexing" in msg and "host" in msg,
              f"[livejournal] {bits} bits refused with {msg!r}")
        t0 = time.perf_counter()
        fut = device_build_async(edges, slice_bits=bits)
        sizes = fut.sizes()
        sizes_s = time.perf_counter() - t0
        del fut
        check(sizes == {k: want[k] for k in sizes} and sizes["candidates"] > limit,
              f"[livejournal] {bits} bits: the device's {sizes} vs the host's {want}")
        log(f"[livejournal] full size, slice_bits {bits}, build='device': ValueError after "
            f"{refused_s:.3f} s ({msg!r}), max_memory_allocated {peak} bytes; device orient + both "
            f"SBF sides {sizes_s:.3f} s: row valid slices {sizes['row_valid']}, column "
            f"{sizes['col_valid']}, candidates {sizes['candidates']} ({sizes['candidates'] / 2**31:.3f}"
            f" x 2^31) == the host build's (compress {want['compress_s']:.2f} s on the host); "
            f"{smi}")
        out[bits] = {"refused_s": refused_s, **sizes}
    del edges
    torch.cuda.empty_cache()

    scaled = np.load(work / "scaled.npy")
    exact = small["exact"]
    chunk = clamp_chunk_pairs(1 << 20, 64 // 32)
    fut = device_build_async(scaled, slice_bits=64)
    sizes = fut.sizes()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    db = fut.result()
    torch.cuda.synchronize()
    schedule_s = time.perf_counter() - t0
    schedule_peak = torch.cuda.max_memory_allocated()
    cb = pow2_ceil(sizes["candidates"])
    check(limit // 2 < sizes["candidates"] <= limit and cb == limit,
          f"[livejournal] x{LJ_LIMIT_SCALE}: {sizes['candidates']} candidates, bucket {cb}")
    log(f"[livejournal] x{LJ_LIMIT_SCALE} (|V|={small['n']} |E|={small['m']}), "
        f"slice_bits 64: {sizes['candidates']} candidates, a bucket of {cb} lanes (the largest the "
        f"device build takes); the schedule step alone {schedule_s:.3f} s, max_memory_allocated "
        f"{schedule_peak} bytes with {before} bytes held before it (graph, SBF), "
        f"{db.worklist.num_pairs} pairs; {smi}")
    del db, fut
    torch.cuda.empty_cache()
    runs = []
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gather_total_cuda.launches = 0
        t0 = time.perf_counter()
        res = tcim_count(scaled, backend="pallas_total", slice_bits=64)
        wall = time.perf_counter() - t0
        launches = gather_total_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        windows = math.ceil(pow2_ceil(res.stats["num_pairs"]) / chunk)
        check(res.stats["build"] == "device" and res.triangles == exact and launches == windows,
              f"[livejournal] x{LJ_LIMIT_SCALE} {label}: {res.triangles} triangles (oracle "
              f"{exact}), build {res.stats['build']!r}, {launches} launches for {windows} windows")
        log(f"[livejournal] x{LJ_LIMIT_SCALE} {label} count, build='auto' on the card: "
            f"{res.triangles} triangles == triangles_intersection, build {res.stats['build']!r}, "
            f"{res.stats['num_pairs']} pairs, {launches} gather_total launches ({windows} windows), "
            f"{wall:.6f} s wall, timings_s {json.dumps(res.timings_s)}, max_memory_allocated "
            f"{peak} bytes; {smi}")
        runs.append({"wall": wall, "launches": launches, "peak": peak, "timings": res.timings_s})
    torch.cuda.empty_cache()
    log(f"[livejournal] phase 22 took {time.perf_counter() - t_phase:.3f} s")
    return {"full": out, "scale": LJ_LIMIT_SCALE, "candidates": sizes["candidates"],
            "pairs": res.stats["num_pairs"], "launches": runs[0]["launches"],
            "schedule_peak": schedule_peak, "runs": runs}


def main() -> int:
    if sys.argv[1:2] == [HOST_CHILD_FLAG]:  # a host child: no card visible to it
        return _host_child(sys.argv[2], Path(sys.argv[3]))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    if sys.argv[1:] == [RESUME_FLAG]:
        return _train_resume_child()
    if sys.argv[1:] == [SHARD_RESUME_FLAG]:
        return _sharded_resume_child()
    if sys.argv[1:] == [FAMILY_RESUME_FLAG]:
        return _family_resume_child()
    t_start = time.perf_counter()
    seconds = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__] = round(time.perf_counter() - t0, 3)
        log(f"[time] {fn.__name__} took {seconds[fn.__name__]:.3f} s")
        return out

    name = timed(phase_device)
    oracles = _start_host_child("oracles")
    cpu_paths = _start_host_child("cpu-paths")
    timed(phase_build)
    err = timed(phase_kernel_cases)
    err_seg = timed(phase_segment_cases)
    err_unfused = timed(phase_unfused_cases)
    main_run = timed(phase_main, oracles, cpu_paths)
    serve = timed(phase_serve)  # before 4b, while the host child builds com-youtube for it
    timed(phase_device_build, main_run, cpu_paths)
    row, err_main, chunks, store_row, store_col = timed(phase_timing, main_run)
    row["max_abs_err"] = max(err, err_main)
    rows, err_serve = timed(phase_serve_timing, serve, chunks, store_row, store_col)
    rows[0]["max_abs_err"] = max(err_seg, err_serve)
    for r in rows[1:]:
        r["max_abs_err"] = max(err_unfused, err_serve)
    err_bitgemm, err_mxu = timed(phase_dense_cases)
    dense = timed(phase_dense, cpu_paths)
    dense_rows = timed(phase_dense_timing, dense)
    dense_rows[0]["max_abs_err"] = err_bitgemm
    for r in dense_rows[1:]:
        r["max_abs_err"] = err_mxu
    err_flash, row_err_flash = timed(phase_flash_cases)
    lm = timed(phase_lm_serve)
    flash_rows = timed(phase_flash_timing, lm)
    stream = timed(phase_stream)
    row["stream_launches_per_batch"] = stream["launches_per_batch"]
    timed(phase_stream_serve)
    row["sharded_launches"] = timed(phase_sharded, main_run)
    timed(phase_contracts, main_run, serve)
    one_device = timed(phase_train)
    timed(phase_cost, lm, one_device)
    timed(phase_families_train, oracles, cpu_paths)
    family_flash, family_rows = timed(phase_families)
    timed(phase_sharded_train, one_device)
    sharded_flash = timed(phase_sharded_serve, lm)
    sharded_flash.update(timed(phase_tensor_parallel_serve))
    lj = timed(phase_livejournal, oracles)
    row["livejournal_launches"] = lj["launches"]
    flash_rows[0]["launches_by_path"] = {"lm_serve": flash_rows[0]["launches"], **family_flash,
                                         **sharded_flash}
    flash_rows[0]["launches"] += sum(family_flash.values()) + sum(sharded_flash.values())
    # The two widths only a family runs: launches on their own paths.
    for arch, r in family_rows.items():
        r["launches_by_path"] = {"families": family_flash[arch]}
        r["launches_by_path"].update({k: v for k, v in sharded_flash.items()
                                      if k.split(":")[1:2] == [arch]})
        r["launches"] = sum(r["launches_by_path"].values())
        flash_rows.append(r)
    for r in flash_rows:
        r["max_abs_err"] = max(r["max_abs_err"], *err_flash.values())
        r["max_row_rel_err"] = max(r["max_row_rel_err"], *row_err_flash.values())
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; seconds by phase "
        f"{json.dumps(seconds)}")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": [row, *rows, *dense_rows, *flash_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
