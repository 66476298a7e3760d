"""Smoke run of the PyTorch/H100 port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (none of their failures is caught; any one fails the run):

1. Card check: CUDA must be present; prints the card's name and power limit.
   The CUDA kernels (``csrc/flash_attention.cu`` with ``csrc/hopper.cuh``,
   and ``csrc/vote_stats.cu``) are built with ``nvcc`` into ``build/cuda/``
   first, one ``nvcc`` per source, started together, and the compiler's
   per-kernel register and spill report is printed. No kernel may spill a
   byte (the ``di`` kernels, ``flash_di_kernel``, must be in the report),
   and ``cuobjdump -sass`` of the flash library must show ``HGMMA``
   (wgmma), ``UTMALDG`` (TMA loads) and no ``HMMA`` (``mma.sync``, as
   ``nvcuda::wmma`` compiles) in each of the forward, dK/dV and dQ kernels,
   at head_dim 64 and at 128 (each instantiation checked on its own), and
   ptxas must not serialize the wgmma of any of them (its "wgmma.mma_async
   instructions are serialized" note: a wait after every product). Each
   ``[sass]`` line also gives the registers the kernel's code names (a
   wgmma accumulator counted over its range) and its ``setmaxnreg`` counts.
2. Kernel phase, optimizer: the two Triton kernels (``ops/fused_lion.py``)
   and the CUDA stats kernel (``csrc/vote_stats.cu``) against their plain
   PyTorch versions on the card, at the main path's size (GPT-2 124M,
   124,439,808 coordinates), at run (d)'s (Llama-2-7B's LoRA adapters,
   4,194,304), at run (j)'s (the DPO adapters, 20,023,320) and at a ragged
   1,000,003: ``fused_ballots``
   and ``fused_apply`` for float32 and bfloat16 params and int8 and int32
   tallies (p, g and m all bfloat16: run (k)'s instantiation, timed at
   124,439,808 against 5 and 11 bytes a coordinate), and at 124,439,808 and 1,000,003 with bfloat16 grads and
   momentum under float32 params (``--mom_dtype bfloat16``, run (h2)); both
   bfloat16 kernels over one window of 2**31 + 4097 coordinates, where a
   1,048,576-coordinate slice straddling 2**31 and the window's tail are
   held to the plain version of the same slices (the int64 offsets), ``bucket_vote_stats`` for a vote of 1 (int8 tally), of 4 (int8
   and int32), of 3 (both) and of 300 (int32), and on windows that start
   at an odd byte offset of a larger buffer, with the tally lined up with
   the ballots and not. Outputs must be ``torch.equal``.
3. Kernel phase, attention: the three flash kernels and the ``di`` kernel
   (``ops/flash_attention.py``) at GPT-2's shape (B 8, H 12, T 1024,
   head_dim 64, bfloat16, q/k/v transposed views of one projection) and at
   a ragged T = 1000; at Llama-2-7B's (B 4, H 32, T 1024, head_dim 128, q
   and k contiguous as rope makes them, v a transposed view of its own
   projection) and at T 2048 and a ragged 1000, at run (j)'s B 2, H 32,
   T 1024, and at run (k)'s B 1, H 32, T 2048 with q, k and v contiguous
   (GQA's repeated kv heads); do always a transposed
   view, as autograd hands it back; and at
   B 2, H 3 with T 40 (shorter than one tile) and 130 at both head dims;
   against the plain versions and against a float64
   reference built from the same bfloat16 inputs. Criterion: for every
   output X (o, lse, dq, dk, dv),
   ``max|X_kernel - X_f64| <= 2 * max|X_plain - X_f64| + slack``, where
   slack is half a bfloat16 ulp of ``max|X_f64|`` for the bfloat16 outputs
   and four float32 ulps of it for the float32 ``lse``. ``di =
   flash_attention_di(o, do)`` on the plain forward's o is held row by row
   to the float64 sum of the same products: ``|di_kernel - di_f64| <= 2 *
   |di_plain - di_f64| + D * 2**-24 * sum|o * do|`` in every row. The
   backward kernels run twice: on the plain forward's o, lse and di (the
   plain backward's inputs), and on the forward kernel's own o and lse with
   the di kernel's di of them, as training chains them; both are held to
   the plain backward's error. Each kernel called twice on the same inputs
   must give the same bits (``torch.equal``). ``torch.nn.functional.scaled_dot_product_attention``
   is timed beside them as the library yardstick (the port never calls
   it): the forward, and the backward with a fresh graph for each timed
   call (its forward runs before the start event), each as median and
   minimum. Each kernel's TFLOP/s is its causal operations over its time;
   each attention kernel's ``[kernel]`` line also names its tiles (from the
   library), registers, and for the forward its ring stages and grid order.
   A ``[library]`` line per head_dim sets the port's whole backward,
   ``flash_attention_di`` + dK/dV + dQ timed as one call, beside SDPA's
   backward. Both head dims are timed at their T 1024 shape. Then
   ``ops/quant.py``:
   ``quantize_nf4`` and ``dequantize`` of a [4096, 11008] weight on the card
   must equal the CPU's bit for bit.
4. Slice phase, in one 1-rank NCCL process group: each flat vote wire must
   return the rank's own ballots as the tally; then ``cli.run_clm.main``
   trains GPT-2 124M at full width (T = 1024, float32 params, bfloat16
   compute, remat) for 3 steps of batch 8 x accumulation 2 and evaluates 2
   batches, twice: (a) the default run (dropout 0.1: training takes the
   materialized-scores branch, eval takes flash) and (b) the main path of
   this slice, ``--dropout 0 --telemetry``. Every kernel's launch counter
   is set to 0 just before each run and read just after. (a): finite
   losses, optimizer kernels steps x buckets, flash forward n_layer x eval
   batches, no backward kernel and no ``di``. (b): finite losses; flash
   forward n_layer x accum x 2 (remat) x steps + n_layer x eval batches;
   ``di``, dK/dV and dQ n_layer x accum x steps each; ``bucket_vote_stats`` and the optimizer
   kernels steps x buckets; ``vote/hist_mass == 1`` and
   ``vote/disagree_frac == 0`` (a vote of one rank). After (b) the trained
   model's eval loss through flash must be finite and within 0.002 of its
   eval loss through ``attention_xla``. (c) ``--dropout 0`` alone: (b)'s
   flash counts and no ``bucket_vote_stats``, so (b) - (c) is the cost of
   telemetry. (c-journal) ``--dropout 0 --journal``: (c)'s losses, final
   params' sha256 and launches; then one more step of each of the two
   trainers under ``torch.profiler`` (host and device activity): the counts
   of synchronizing CUDA runtime calls (``cudaStreamSynchronize``,
   ``cudaDeviceSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy``)
   and of device-to-host copies must be equal (the journal adds no sync);
   both runs' step times and the journal's attribution
   (``cli/run_analyze.py``) are printed. (c-dots) ``--dropout 0
   --remat_policy dots``: losses, final params and momentum ``torch.equal``
   to (c)'s, (c)'s launches; its peak device memory and median step are
   printed beside (c)'s. (d) ``cli.run_sft.main``: Llama-2-7B at full width and depth
   (32 layers, d 4096, 32 heads of 128, d_ff 11008; the byte vocabulary,
   259), an NF4 base, LoRA r 8 on wq/wv (4,194,304 trainable coordinates),
   ``--attn_impl flash``, B 4 x accumulation 2 x T 1024, 3 steps and the
   run's eval: finite losses; flash forward at head_dim 128 32 x 2 (remat)
   x accum x steps + 32 x eval batches, ``di``, dK/dV and dQ 32 x accum x
   steps, no head_dim 64 launch; the optimizer kernels steps x buckets; the
   frozen base equal (codes, absmax, norm scales) to a fresh init from the
   same seed; eval loss through flash within 0.002 of attention_xla's;
   step ms, tokens/s and peak device memory. After (c) and after (d),
   ``torch.profiler`` traces one forward + backward microbatch of the run's
   model (GPT-2: B 8; Llama: B 4; T 1024, bfloat16 compute, remat),
   recording device activity only, and prints the ten device kernels with
   the most time and the flash kernels wherever they rank (total ms,
   calls), and the device's idle share over the traced window (1 - the
   union of device activity over the window from the first to the last
   device event), beside three unprofiled microbatches timed on the host
   clock. The wire check also times ``sign_psum`` at the main path's size
   with and without the copy that keeps the ballots (telemetry's case).
   Before the runs a tiny float32 model's logits on the card must match
   the CPU's, and the float32-result products (``ops/products.py``) must
   agree with float64 products of the same bfloat16 operands to 1/16 of a
   bfloat16 ulp of the largest value.
   (e) ``--dropout 0 --max_grad_norm 1.0``: the stochastic mode at (c)'s
   setup; (c)'s flash counts and no optimizer kernel (its ballots and
   update are plain PyTorch, as the JAX package's XLA path). Then its
   ballots on seeded g and m at 124,439,808 coordinates: equal to the
   deterministic ballots where ``|u| >= r``, the same bits from the same
   (seed, count, rank), other bits from another rank, and the mean of
   ``ballot - (2p - 1)`` within 6 standard deviations of 0 (its step's
   device time: phase 7). (n) The NaN sentinel at (c)'s setup:
   ``--nan_sentinel --trace_on_anomaly --profile_dir <d>
   --profile_start_step 1 --profile_num_steps 1 --inject_poison
   nan_grads:0:2 --output_dir <o>``, 8 steps asked: it must raise exactly
   ``FloatingPointError("non-finite grad_norm=nan at step 3")`` after step
   6 (the check of step 3 runs after step 4 is issued, then one step is
   traced and one more run); ``<o>/crash/step_00000003/bundle.json``
   (strict JSON) lists momentum leaves holding all 124,439,808 coordinates
   and no param (a NaN ballot votes -1); the ``<d>`` trace of step 1 and
   the anomaly trace of step 4 under the bundle both name the Triton
   kernels; the launches are 6 steps' and no eval batch; with
   ``--journal`` the bundle holds ``journal_tail.jsonl`` (strict JSON)
   whose last record is the trip's ``[trainer] ANOMALY`` message.
   (y1) GPT-2-MoE, right after (c-dots): (b)'s setup with ``--moe_experts 8
   --moe_every 2 --moe_capacity_factor 1.25`` (GPT-2 124M's widths and 12
   blocks, 6 of them with 8 experts of d_ff 3072: 322,818,816 coordinates):
   finite losses, that count, (b)'s launch formulas (every block's attention
   takes flash), ``vote/hist_mass == 1``, eval through flash within 0.002 of
   attention_xla's; the optimizer kernels are held ``torch.equal`` to their
   plain versions at this window in the kernel phase. Then the first MoE
   block's routing of B 8 x T 1024 tokens through the trained model on the
   card (``parallel.expert.route``): every kept token in a slot of its own
   and each expert's drops ``max(0, count - C)`` at C = 1,280; and a profiled
   microbatch. Its step ms, tokens/s and peak device memory are printed.
5. Run (f), the vote across four ranks: four processes on cuda:0 in a
   gloo process group the script starts itself (NCCL refuses two ranks
   on one device) each run ``cli.run_clm.main`` on GPT-2 124M's widths cut
   to 2 layers (53,561,088 coordinates; every GPT-2 run of this spawn is cut
   so, through ``gpt2_cut``: the CLIs have no depth flag, and the vote's
   checks do not depend on the depth), B 2 x accumulation 1 x T 1024,
   ``--dropout 0 --telemetry``,
   constant LR, 2 steps, on ``sign_psum``, ``sign_psum --max_grad_norm
   1.0``, ``packed_a2a`` and ``hier:2``. After every step all four
   ranks' flat params must be ``torch.equal``; at step 1 each
   deterministic wire's election must equal the plain election of the
   four gathered ballots (a strict majority, ties -1; for ``hier:2`` a
   strict majority of the two groups' strict majorities), and on
   ``sign_psum`` the telemetry margin histogram and disagreement must
   equal ``bucket_vote_stats_plain`` of the gathered tally. Every
   rank's launch counts are checked. Then each rank saves a CUDA tensor
   as an async checkpoint step: the commit thread (a gloo group of its
   own) must commit it with no later save and no ``close()``. Its step
   times are not a rate of the card: four ranks share it and gloo stages
   every collective through the host. Run (m), the vote guard, rides the
   same spawn with (f)'s checks: (m1) ``packed_a2a --vote_guard
   enforce``, 2 steps: no transition, and the final params' sha256 equal
   to (f) ``packed_a2a``'s; (m2) ``packed_a2a --vote_guard enforce
   --nan_sentinel --inject_poison nan_grads:1:1 --guard_strikes 2
   --guard_cooldown 3``, 8 steps: rank 1 quarantined at step 3, readmitted
   at 6 and quarantined again at 8 (``M2_EVENTS``, as
   tests/test_torch_vote_guard.py pins them against the JAX trainer),
   every loss finite, the sentinel silent, every rank's momentum finite,
   the mask and the strikes in every logged row; (m3) ``sign_psum
   --vote_guard enforce --inject_poison flipped_ballot:2 --guard_strikes
   1``, 3 steps: rank 2 quarantined as an outlier, and at every step the
   election and the stats kernel's histogram and disagreement equal to
   their plain versions on the gathered tally masked by the step's health
   mask, with at least one step masked. Under the guard the
   ``StepWatch`` checks the election at every step, the ballots those of
   the sanitized grads. Run (p), the control plane and the run journal,
   rides it too: ``sign_psum --telemetry --journal --control_plane
   --rejoin_probe_steps 2 --inject_membership
   worker_drop:1:2,worker_rejoin:1:5``, 8 steps: every step's election
   equal to the plain election under that step's mask (3 voters at steps
   3-5, ``P_VOTERS``), the stats kernel's histogram and disagreement equal
   to ``bucket_vote_stats_plain`` of the gathered masked tally at every
   step; rank 1's lifecycle at every boundary ``P_LIFECYCLE`` (departed at
   boundary 2, rejoining at 5, healthy at 7), the four ranks' equal; after
   the rejoin rank 1's momentum ``torch.equal`` to the mean of ranks 0, 2
   and 3 summed in rank order; finite losses and momentum;
   ``comm_drift_bytes`` and ``host_step_skew`` 0 in every row; then the
   four journals (strict JSON) through ``cli/run_analyze.analyze_dir``: no
   schema error, every rank's attribution closing with coverage >= 0.95,
   and the membership timeline exactly the drop, the rejoin and the
   probation's end. Run (q), the cross-step DCN pipeline, rides it too:
   (q1) ``hier:2 --dcn_pipeline_depth 2 --vote_guard enforce`` with (f)'s
   ``--telemetry``, 6 steps, under the ``StepWatch``: steps 1-2 apply no
   sign step (the params ``torch.equal`` to a plain decay of the previous
   ones); from step 3 each step's applied election equal to the plain
   ``hier:2`` election of the four ranks' gathered ballots of step t - 2,
   and the stats kernel's disagreement (this step's ballots against that
   stale election) equal to ``bucket_vote_stats_plain``'s; params equal on
   every rank; each rank's ring ``[2, hier_ring_slot_bytes(N, 4, 2,
   buckets)]`` uint8 (6,695,138 bytes a slot at one bucket);
   ``comm_drift_bytes`` 0 and ``dcn_overlap_frac`` 1 in every row;
   ``fused_ballots`` every step, ``fused_apply`` and ``bucket_vote_stats``
   from step 3. (q2) ``hier:2 --vote_every 4 --dcn_pipeline_depth 1``, 5
   steps: every landed slot's election equal to the plain election of its
   slice ballots one step before, slot j first moving at step j + 2 (every
   other coordinate equal to its decay), the cache after step 5 a plain
   re-election of every landed slot, the wire's bytes a step equal to
   ``wire_bytes_per_param``. (q3) the ``dcn_delay`` link (1.0 s, armed
   through ``resilience.inject_fault`` before each trainer is built):
   (q1)'s setup for 4 steps and a depth-0 twin for 3; the two
   ``dcn_wait_s`` sums are printed, depth 2's below depth 0's and depth
   0's at least twice the delay. Run (r), ZeRO-1, rides it too: (f)'s
   setup with ``--lion false --async_grad false --zero1`` (no telemetry),
   3 steps, under a ``ZeroWatch``: params equal on every rank after every
   step; after step 1 the params and the gathered ``m`` and ``v`` chunks
   ``torch.equal`` to zero.py's formula in plain ops over the full vector
   from the step's averaged grads; ``m`` and ``v`` float32 [13,390,272] a
   rank; finite losses; no optimizer kernel and (f)'s flash launches; the
   state's bytes a rank printed beside the replicated AdamW's.
   Runs (s1), (s2), (t) and (u), tensor parallelism, ride it too, as dp 2 x
   tp 2 (global rank r is data rank r // 2, tensor rank r % 2), 2 steps each
   ((t) 3) on ``sign_psum``: (s1) ``run_clm`` GPT-2 124M's widths at 2 layers,
   T 1024, ``--dropout 0 --tensor_parallel 2``, B 2 x 1 (46,477,824
   coordinates a rank); (s2) (s1) + ``--tp_vocab --vocab_pad_multiple 64``
   (27,197,184);
   (t) ``run_sft`` at Llama-2-7B's widths and vocabulary (d 4096, 32 heads,
   d_ff 11008, 32,000 rows) cut to 4 layers, NF4 base, LoRA r 8 on wq/wv, B
   2 x T 1024; (u) ``run_clm --model_family llama`` at Llama-3-8B's widths
   cut to 2 layers, bfloat16 params, T 2048, ``--tensor_parallel 2
   --tp_vocab``, B 1 x 1 (the depth cut through ``llama_cut``: the CLIs have
   no depth flag). Under a ``GridWatch`` on every rank: the replicated leaves
   ``torch.equal`` across the tensor ranks after every step and the losses
   equal across them; up to 2e8 coordinates every step's params and
   momentum ``torch.equal`` to the plain apply of the plain election of the
   data group's gathered ballots, and the params equal across the data
   ranks; dp x tp == dp at step 1, and (t)'s at step 3 (B is zero until a
   step with lr > 0 moves it, and the warmup's lr is 0 at step 1, so A's
   gradient is zero at steps 1 and 2): the momentum step ``(1 - b2)·g`` gathered
   over the tensor group into the whole leaves against the unsplit model's
   gradient on the same microbatch and weights (through
   ``attention_xla``), per-leaf median ratio within 1e-2 of 1 on every
   leaf (a leaf without a nonzero gradient fails), the largest difference
   and the share of equal ballots printed; (t)'s NF4 codes and
   absmax ``torch.equal`` to the slices of the whole quantized base; each
   rank's kernel launches against their formulas; peak device memory a
   rank. The kernel phase holds the optimizer kernels at these runs'
   windows and the flash kernels at their shapes (H 6 hd 64 with the q, k,
   v views of the rank's projection; H 16 hd 128 at T 1024 and at T 2048).
   It prints the step times and each rank's buckets.
   Runs (v1)-(x2), sequence parallelism, ride it too (global rank r = (d·tp +
   t)·sp + s), 2 steps each ((x1) 3) on ``sign_psum``: (v1) ``run_clm`` GPT-2 124M's
   widths at 2 layers, T 1024, float32 compute, dp 2 x sp 2, ring, ``--dropout 0
   --telemetry``, B 2 x 1; (v2) (v1) with ``--seq_impl ulysses`` and no
   telemetry; (v3) dp 1 x tp 2 x sp 2, ring; (w) ``run_clm --model_family llama`` at Llama-3-8B's
   widths cut to 2 layers, bfloat16, T 8192 over dp 1 x sp 4 (2,048 tokens a
   rank), ring, ``--vocab_chunks 8``, B 1 x 1; (x1) ``run_sft --packing
   --seq_parallel 2`` at Llama-2-7B's widths and 32,000 rows cut to 4
   layers, NF4 base, LoRA r 8 on wq/wv, T 2048, no adapter dropout (its
   masks would differ by chunk from the unsplit model's), dp 2 x sp 2; (x2)
   ``run_dpo --seq_parallel 2`` at Llama-2-7B's widths cut to 2 layers,
   ``--max_length 1024``, dp 2 x sp 2. The same ``GridWatch`` adds: each
   rank's params and momentum hash (sha256) to its seq peers' after every
   step; losses equal across every rank of a data rank; with telemetry each
   step's margin histogram and disagreement equal ``bucket_vote_stats_plain``
   of the gathered tally; sp == dp at step 1 ((x1) at step 3) against the
   unsplit model on the data rank's whole rows (at (w)'s T 8192 through the
   flash kernels, their launches taken back out of the counts, and the head
   chunked as the run's), median ratio within 1e-3 of 1 at float32 ((v1)-(v3))
   and 1e-2 at bfloat16 ((w), (x1)), and >= 99% equal ballots; (x2) has no
   such check. The seq axis's two collectives are timed on the host clock
   at (v1)'s shapes (the gradient's ``all_reduce`` over the seq pair and one
   ring hop of a layer's k and v, through gloo). No flash kernel launches in these runs
   (every seq-parallel attention, eval's too, is the ring's or Ulysses');
   the kernel phase holds the optimizer kernels at (w)'s, (x1)'s and (x2)'s
   windows.
   Runs (y2) and (y3), expert parallelism, follow in a W = 4 spawn of their
   own, fresh processes (global rank r =
   ((d·tp + t)·sp + s)·ep + e), GPT-2-MoE at (y1)'s widths and depth, B 2 x
   1: (y2) dp 2 x ep 2, float32 compute, capacity factor 8 (nothing drops),
   ``--ep_dcn_pipeline 0``, 2 steps (209,480,448 coordinates a rank); (y3) dp
   1 x tp 2 x ep 2, bfloat16, capacity factor 1.25, ``--ep_dcn_pipeline 2``,
   5 steps (124,485,888). The ``GridWatch`` holds every leaf replicated over
   the expert axis (and over tensor) ``torch.equal`` across those ranks after
   every step, the losses equal across a data rank's ranks, the launches by
   formula, and for (y2) ep == the unsplit model at step 1 on the expert
   pair's rows (loss + 0.01·aux, median momentum ratio within 1e-3 of 1 on
   every leaf); a ``RingWatch`` holds (y3)'s ring: steps 1-2 read an
   all-zero slot (the local aux), each later step the slot the step two
   before wrote, and each slot the step's tallies of every microbatch
   summed over the expert group by the watch itself, 4,096 lanes a block.
   The kernel phase holds the optimizer kernels at (y2)'s window.
   Runs (z1)-(z4), pipeline parallelism, follow in a W = 4 spawn of their
   own (global rank r = (((d·tp + t)·sp + s)·pp + p)·ep + e; its gloo
   group under a 600 s timeout), 2 steps each on ``sign_psum`` at dropout 0
   and bfloat16 compute, one eval batch each: (z1) ``run_clm`` GPT-2 124M's
   widths cut to 4 blocks (``gpt2_cut``), T 1024, float32 params, dp 2 x pp
   2, 4 microbatches of B 4 (53,561,088 coordinates a rank: 2 blocks and the
   replicated wte, wpe and ln_f); (z2) dp 1 x pp 4, 8 microbatches of B 8
   (46,473,216: stages 1 and 2 neither embed nor take the loss); (z3) dp 1 x
   tp 2 x pp 2, 4 microbatches of B 4 (46,477,824); (z4) ``run_clm --model_family llama``
   at Llama-3-8B's widths cut to 4 layers (2 a stage), bfloat16 params, T
   2048, ``--vocab_chunks 8``, dp 2 x pp 2, 2 microbatches of B 2
   (1,486,901,248). The ``GridWatch`` holds every rank's replicated leaves
   (wte, wpe, ln_f; Llama's lm_head) sha256-equal to every stage's after
   every step, the losses equal across a data rank's ranks, up to 2e8
   coordinates the plain apply of the plain election, the launches by formula
   (a stage's blocks x microbatches: forward twice a step (remat) and once an
   eval batch, each backward kernel once), and for (z1) and (z2) pp == the
   unsplit model at step 1: each leaf's momentum step, gathered from the
   stages to stage 0, against the unsplit model's gradient on the data
   rank's rows (median ratio within 1e-2 of 1 on every leaf). Each run's
   line gives its bubble fraction (pp - 1)/(M + pp - 1), step ms and peak a
   rank. The kernel phase holds the optimizer kernels at (z1)-(z3)'s windows
   ((z4)'s is (w)'s) and the flash kernels at their microbatches' shapes.
6. Run (g), resume on the card, in the 1-rank NCCL group: the repo's
   ``*.md`` files go through the port's GPT-2 BPE (``runs/parity/tok``,
   its C++ merge core, which must build) into a uint16 ``bin:`` shard, read
   by the C++ native loader (each row's ``skipped_shards`` counter, 0,
   shows it served the batches). ``cli.run_clm.main`` trains GPT-2 124M at
   full width, B 8 x accumulation 2 x T 1024, ``--dropout 0 --telemetry
   --save_steps 2``, 4 steps twice, with async and with synchronous saves:
   losses, params, momentum and every vote-health counter ``torch.equal``.
   Then 2 steps into a fresh directory, and a fresh process (this script
   with ``--resume-child``) resumes from step 2 to 4: ``torch.equal`` to
   the uninterrupted run in the same four, its launches those of 2 steps;
   the same once more with ``--max_grad_norm 1.0`` (the stochastic draws),
   where (o) the resumed process gets SIGTERM from its data iterator at
   batch 3 (``--on_preempt save_exit``, the default): it must exit 0 at
   step 3 with a committed checkpoint tagged ``preempt`` and no eval, and a
   third process resumes from it to step 4, the whole still ``torch.equal``
   to the uninterrupted run.
   The resumed step verifies (``train.resilience.verify_step_dir``); torn
   by ``tear_leaf_file`` it does not, and autodetect falls back to step 2.
   It prints the checkpoint's bytes, ``ckpt_stall_s`` async against
   synchronous, the commit time, the resume time, the native BPE's host
   tokens/s and the data wait per step.
   Each phase prints its wall time.
7. Runs (h) and (i), the optimizer's other modes, in the 1-rank NCCL
   group at (b)'s setup: (h1) ``--vote_every 4 --lr_scheduler_type
   constant``, 5 steps (a rotation and one slot more), under a
   ``StepWatch``: every step's slice election equal to the plain election
   of the slice's ballots, the cache after step 5 equal to a plain
   re-election of every slot, at step 1 the coordinates of slots 1-3 equal
   to their decayed values (no sign step) and every coordinate of slot 0
   moved, the wire's recorded bytes equal to ``wire_bytes_per_param``, the
   launches by their formula (``optimizer_launches``); (h2) ``--mom_dtype
   bfloat16``, 3 steps: bfloat16 momentum under float32 params, its bytes
   printed; (i) ``--lion false --async_grad false`` (AdamW), 3 steps: no
   optimizer kernel, (c)'s flash launches. Then the device time of one
   optimizer step at 124,439,808 coordinates in a world of one: fused,
   stochastic, lazy (every slot voted, and its first step), lazy under
   stochastic binarization (every slot voted), fused at bfloat16 momentum,
   the fused step under ``guard enforce`` and ``guard observe`` (with the
   bytes the guard adds, and for them and fused one profiled step's
   kernels), AdamW. Run (f) gains ``packed_a2a --vote_every 4``, 5 steps, under the
   same checks on every rank, with the bits per param per step printed.
   (h3) ``--vote_every 4 --max_grad_norm 1.0`` at (h1)'s setup, 5 steps,
   under the ``StepWatch``, whose plain elections take the slice ballots
   replayed from (seed, count, rank) (``replay_slice_ballots``): (h1)'s
   checks, no ballot kernel (the stochastic ballots are plain ops), and
   ``vote/stoch_flip_frac`` in (0, 1) at every step.
8. Run (j), DPO, in the 1-rank NCCL group: ``cli.run_dpo.main`` on
   Llama-2-7B at full width and depth (the byte vocabulary, 259) with a
   dense float32 policy base, an NF4 reference (``--quant_ref nf4``), LoRA r
   8 over the DPO target set (wq, wk, wv, wo, w_gate, w_up, w_down and wte:
   20,023,320 trainable coordinates), ``--attn_impl flash --telemetry``,
   B 2 pairs x accumulation 2 x T 1024, 3 steps and 2 eval batches of 2
   pairs: finite losses; the trainable coordinates; flash forward at
   head_dim 128 32 x (6 x accum x steps + 4 x eval batches) (two policy
   passes each run twice under remat, two reference passes under no_grad;
   four passes an eval batch), ``di``, dK/dV and dQ 32 x 2 x accum x steps,
   the optimizer and stats kernels steps x buckets; eval metrics
   ``eval/loss``, ``eval/reward_accuracy`` and ``eval/reward_margin``
   only; the dense base and the NF4 reference ``torch.equal`` to a fresh
   init from the same seed and its quantization; and, exactly, at fresh
   adapters (B = 0) against the dense base, one eval batch's loss
   ``torch.equal`` to ``-logsigmoid(0)`` and reward_margin 0. It prints
   step ms, tokens/s (pairs x T), peak device memory and a profiled
   microbatch.
9. Run (k), full-parameter Llama pretraining, in the 1-rank NCCL group:
   ``cli.run_clm.main --model_family llama --model_name llama3_8b``
   (Llama-3-8B at full width and depth: 32 layers, d 4096, 32 heads of 128
   over 8 kv heads, d_ff 14336, vocabulary 128,256; 8,030,261,248 bfloat16
   params, grads and momentum) ``--param_dtype bfloat16 --compute_dtype
   bfloat16 --dropout 0 --block_size 2048 --vocab_chunks 8``, B 1 x
   accumulation 2, 3 steps, 2 eval batches of synthetic tokens, on
   ``sign_psum``: finite losses; the optimizer kernels once a step each
   (their bfloat16-param instantiation past 2**31 coordinates), the flash
   kernels at head_dim 128 (``auto`` at T 2048; q, k and v contiguous, the
   kv heads repeated) 32 x (accum x 2 x steps + eval batches) forward and
   32 x accum x steps each backward kernel; the params' count; step ms,
   tokens/s, peak device memory, a profiled microbatch and the device time
   of one optimizer step over the 8.03B coordinates beside its byte bound.
   Then the ``[xent]`` check at that run's head (N 2047, d 4096, V 128,256,
   bfloat16 hidden states and ``lm_head`` ``[d, V]``): the chunked loss of
   ``ops/xent.py`` at 8 chunks against the dense ``matmul_f32`` head +
   ``clm_loss_and_metrics``, forward and backward: losses within 1e-4, equal
   ``correct`` counts (half the labels are the float64 argmax), and each
   gradient's max error against a float64 reference within 2 x the dense
   one's plus half a bfloat16 ulp of its largest value. Each path's peak
   device memory above its inputs is printed, and so is its working memory,
   that peak less the two gradients every backward returns (``d hidden``
   and ``d lm_head``, 1.07 GB); the chunked working memory must be at most
   a quarter of the dense one's.
10. Run (l), Hugging Face checkpoints in and out, in the 1-rank NCCL group.
   First ``[tok]``: a ``tokenizer.json`` built from ``runs/parity/tok``
   (``data.hf_tokenizer_json.bpe_tokenizer_json``) must encode the repo's
   ``*.md`` to the GPT-2 BPE's ids; the host tokens/s of ``TokenizerJSON``
   and of ``SentencePieceTokenizer`` (on a Llama-shaped model written by
   ``write_model_proto`` from the same vocabulary) are printed. (l1): a
   seeded bfloat16 Llama-2-7B (``llama_init``, vocabulary 32,000) written
   by ``models.hf_export.llama_to_hf`` as HF publishes ``Llama-2-7b-hf``
   (two safetensors shards under ``model.safetensors.index.json``, 13.5 GB,
   the page cache dropped after the write) with that ``tokenizer.json``;
   ``cli.run_sft.main --model_path <dir> --tokenizer_name <dir> --quant
   nf4 --attn_impl flash --adapter_output <dir>`` at run (d)'s B 4 x
   accumulation 2 x T 1024, 3 steps: finite losses; the first and last
   blocks' and the head's imported leaves ``torch.equal`` to the written
   ones through float32 and ``quantize_leaf`` (NF4 codes and absmax);
   run (d)'s kernel launches (the eval batches of this tokenizer);
   ``peft_to_lora`` of the written adapters ``torch.equal`` to the
   trainer's. (l2): Llama-2-7B's width at 2 layers, ``run_sft
   --adapter_output --merged_output <HF dir>`` 1 step: the merged
   directory read back by ``llama_from_hf`` ``torch.equal`` to
   ``dequantize_tree(merge_lora(base, adapters))``; then ``run_sft
   --adapter_path`` starts from those adapters (``torch.equal``) and
   trains 1 step. (l3): a seeded GPT-2 124M written by ``gpt2_to_hf``
   (Conv1D layout, vocabulary 50,257), ``cli.run_clm.main --model_path
   <dir> --vocab_pad_multiple 64 --hf_export <dir>`` at run (c)'s setup, 3
   steps: the imported tree ``torch.equal`` to the written one with 47
   zero alignment rows; the export read back ``torch.equal`` to the final
   weights with those rows sliced off; (c)'s launches. Each ``[hf]`` line
   gives the bytes written and read, the seconds to write, to import (disk
   to device-resident tree) and to quantize, the import's GB/s, the host
   RSS before and during the import and the run (sampled every 5 ms) and
   the process's peak (``getrusage``), and the steps beside (d)'s and
   (c)'s.
11. ``[chunk]`` and ``[generate]``, in the 1-rank NCCL group right after
   (c-dots). ``[chunk]``: run (c) (``--dropout 0``) for 8 steps step by
   step, then with ``--steps_per_call 4`` (two chunks of four steps, each
   chunk's batches staged in one copy and its steps issued back to back),
   every kernel counter at 0 before each run and read after: final params
   and momentum ``torch.equal``, launches equal to each other and to (c)'s
   formulas, the chunked run logged at steps 4 and 8 with each loss the
   mean of its chunk's four; both runs' step times printed (host clock,
   not a claim). ``[generate]`` (``models/generate.py``, no kernel: the
   counters must stay 0): GPT-2 124M at full width and depth (random
   weights from seed 0, bfloat16 compute) decodes a left-padded batch of 8
   random prompts of 32-512 tokens and 128 greedy tokens from a dense KV
   cache; each row's prefill and decode logits against the model's own
   forward on its prompt and tokens (bfloat16, flash), both held to the
   same weights at float32 compute: ``max|decode - f32| <= 2 max|forward -
   f32| + 2^-8 max|f32|``; each row decoded solo gives the same tokens up
   to the first whose solo top-2 margin is below the batched-vs-solo logit
   gap measured up to it (the gap is printed: cuBLAS may take other
   algorithms at another batch size). Prefill ms and ms a decode token
   (CUDA events), tokens/s (host clock around the call) and peak device
   memory are printed. Then the same for Llama-3-8B's widths (GQA 32/8,
   vocabulary 128,256, rope theta 500,000, bfloat16 params) cut to 2
   layers, and one ``cli.run_generate.main`` over a ``--prompt_file`` of
   three prompts (GPT-2 124M, random init, byte vocabulary).
12. ``[mixed]``, right after the optimizer kernel phase, no process group:
   one ``DistributedLion`` step (a world of one, 3 buckets, weight decay
   0.1) over GPT-2 124M's leaves as a mixed-dtype tree in leaf order
   (matrices bfloat16, biases and LayerNorm params float32, momenta in the
   params' dtypes) from random params, grads and momenta, every counter at
   0 before and read after: the ballot and apply kernels must launch once
   a window of each bucket on the window's dtype (``.by_dtype``), and the
   params and momenta must be ``torch.equal`` to the plain per-window
   version of the same step. The step's device time is printed.
13. ``[serve]``, in the 1-rank NCCL group right after ``[generate]``
   (``serve/``, no kernel: the counters must stay 0). GPT-2 124M at full
   width and depth (random weights from seed 0, bfloat16 compute) through
   the serving engine: 8 slots, pages of 16 tokens, 64 pages a sequence
   (1,024 tokens, n_ctx), a pool of 512 pages; 16 requests of 32-512
   random tokens, one every 3 engine ticks, 64 greedy tokens each, every
   completion at its budget. Each completion against its solo dense
   ``models.generate.generate``: the same tokens up to the first whose solo
   top-2 margin is below the engine-vs-solo logit gap measured up to it
   (``[generate]``'s criterion). Paged against dense decode on the card
   (a prompt of 288 tokens and 8 greedy steps at 1,024 slots through a
   shuffled table): ``torch.equal``, or where that fails the
   float32-anchored bound of ``[generate]`` (the line says which held).
   ``prefix_cache`` on 16 prompts sharing 256 tokens against the same
   prompts unshared: the same tokens (or the same criterion, the line
   counts both), fewer physical pages. Then ``cli.run_serve.main
   --quant nf4`` over a request file (8 random prompts and a text one,
   staggered) at Llama-3-8B's widths and vocabulary cut to 2 layers: every
   record stops at its budget or at EOS, and the served tree's bytes are
   printed against bfloat16's. Prefill ms by bucket and ms a decode tick at
   batch 8 (CUDA events around each dispatch), tokens/s over the workload
   (host clock), peak device memory and the pool's bytes are printed.

Times are medians of 25 CUDA-event runs after 3 warm-up calls, queued
while the card sleeps (``torch.cuda._sleep``) so that they time the card's
work and not the host's launches. Bounds are
the larger of bytes moved (each input read once, each output written once)
over the card's data-sheet bandwidth and the operations done (causal
products counted over the pairs k <= q only) over its data-sheet bfloat16
tensor rate (for ``di``, its float32 multiply-adds over the float32 rate
outside the tensor cores). The line before the last is the per-kernel JSON record (one
entry per kernel instantiation: the head_dim 128 flash kernels carry the
suffix ``_hd128``, the bfloat16-momentum optimizer kernels ``_mom_bf16``;
launches of the optimizer and head_dim 64 kernels are run (b)'s, of the
head_dim 128 kernels run (d)'s, of the ``_mom_bf16`` ones run (h2)'s, of
the ``_p_bf16`` ones, p, g and m bfloat16, run (k)'s); the last line is
``{"ok": true, "device": {...}}``. Each entry of the kernel record also
carries ``pipeline_launches``, rank 0's launches summed over (z1)-(z4),
``chunk_launches``, the chunked run's of ``[chunk]``, ``generate_launches``,
``[generate]``'s and ``serve_launches``, ``[serve]``'s (0: decoding runs
no kernel), and ``mixed_launches``,
``[mixed]``'s; these three split the ballot and apply launches by the
momentum dtype each ran on (``.by_dtype`` of the wrappers).
"""

import concurrent.futures
import contextlib
import dataclasses
import datetime
import gc
import hashlib
import json
import math
import os
import pathlib
import resource
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F

from distributed_lion_tpu_torch.cli import (
    run_analyze,
    run_clm,
    run_dpo,
    run_generate,
    run_serve,
    run_sft,
)
from distributed_lion_tpu_torch.data import spm
from distributed_lion_tpu_torch.data.bpe import BPETokenizer, unicode_to_bytes
from distributed_lion_tpu_torch.data.sources import batch_iterator
from distributed_lion_tpu_torch.data.dpo import prepare_dpo_batch
from distributed_lion_tpu_torch.data.hf_tokenizer_json import TokenizerJSON, bpe_tokenizer_json
from distributed_lion_tpu_torch.data.tokenizer import ByteTokenizer
from distributed_lion_tpu_torch.models import hf_export, hf_import
from distributed_lion_tpu_torch.models.generate import generate
from distributed_lion_tpu_torch.models.gpt2 import (
    GPT2,
    GPT2Config,
    gpt2_decode,
    gpt2_decode_paged,
    gpt2_init_cache,
    jax_leaf_order,
)
from distributed_lion_tpu_torch.models.gpt2 import _layer_norm as gpt2_layer_norm
from distributed_lion_tpu_torch.models.gpt2_pipe import GPT2Stage
from distributed_lion_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    as_parameters,
    llama_decode,
    llama_init,
    llama_init_cache,
)
from distributed_lion_tpu_torch.models.loss import clm_loss_and_metrics
from distributed_lion_tpu_torch.models.lora import (
    DPO_TARGET_PATTERNS,
    LoraConfig,
    apply_adapters,
    iter_paths,
    lora_init,
    merge_lora,
)
from distributed_lion_tpu_torch.ops import cuda_build, fused_lion, lion_math, quant
from distributed_lion_tpu_torch.ops import flash_attention as fa
from distributed_lion_tpu_torch.ops.codec import (
    bucket_bounds,
    hier_ring_slot_bytes,
    pack_signs,
    parse_wire,
    unpack_signs,
    vote_chunk_elems,
    wire_bytes_per_param,
)
from distributed_lion_tpu_torch.ops.products import matmul_f32
from distributed_lion_tpu_torch.ops.xent import chunked_clm_loss_and_metrics
from distributed_lion_tpu_torch.optim.distributed_lion import DistributedLion
from distributed_lion_tpu_torch.optim.lion import FlatParams, momenta, resolve_lr
from distributed_lion_tpu_torch.optim.optax_adapter import adamw
from distributed_lion_tpu_torch.optim.zero import AdamWZero1, Zero1State, zero1_chunk
from distributed_lion_tpu_torch.parallel import collectives
from distributed_lion_tpu_torch.parallel import tensor_parallel as tpar
from distributed_lion_tpu_torch.parallel.expert import AUX_WEIGHT, capacity, route
from distributed_lion_tpu_torch.parallel.mesh import make_grid
from distributed_lion_tpu_torch.parallel.pipeline import bubble_fraction
from distributed_lion_tpu_torch.train import journal, resilience, vote_guard
from distributed_lion_tpu_torch.train import loop as train_loop
from distributed_lion_tpu_torch.train.checkpoint import Checkpointer
from distributed_lion_tpu_torch.serve import kv_cache
from distributed_lion_tpu_torch.serve.engine import (
    Request,
    ServeConfig,
    ServeModel,
    ServingEngine,
    weight_bytes,
)
from distributed_lion_tpu_torch.utils.serialization import tree_from_state_dict

N_MAIN = 124_439_808   # GPT-2 124M coordinates: the main path's window
# run (d)'s window: Llama-2-7B's LoRA adapters, r 8 on wq and wv of 32
# blocks, each A [4096, 8] and B [8, 4096]
N_SFT = 32 * 2 * (4096 * 8 + 8 * 4096)
# run (j)'s window: the DPO adapters of Llama-2-7B, r 8 on wq, wk, wv, wo
# ([4096, 8] + [8, 4096] each), w_gate, w_up ([4096, 8] + [8, 11008]) and
# w_down ([11008, 8] + [8, 4096]) of 32 blocks, and on wte ([259, 8] +
# [8, 4096])
N_DPO = 32 * (4 * 2 * 4096 * 8 + 3 * (4096 * 8 + 8 * 11008)) + 259 * 8 + 8 * 4096
N_RAGGED = 1_000_003
# run (k)'s window: Llama-3-8B, 32 blocks of 218,112,000 (wq, wo 4096^2;
# wk, wv 4096 x 1024; w_gate, w_up, w_down 4096 x 14336; two norms), wte
# and lm_head 128,256 x 4096 each, ln_f 4096
N_LLAMA3 = 32 * 218_112_000 + 2 * 525_336_576 + 4096
N_BIG = 2**31 + 4097   # one window past int32 offsets: the bfloat16 kernels' int64 check
BIG_SLICE = 1 << 20    # the slices of N_BIG held to the plain version
FLASH_SMALL = ((2, 3, 40), (2, 3, 130))  # (B, H, T): shorter than one tile, one tile and a bit
# (head_dim, B, H, timed T, the other T at B x H, the operands that are
# transposed views of one projection): GPT-2 124M's microbatch, q/k/v all
# three from c_attn; Llama-2-7B's, v from wv and q, k contiguous (rope makes
# new tensors), with T 2048 where auto takes flash for it
# run (j)'s DPO microbatch is B 2 at head_dim 128: one more shape there
# run (k)'s (Llama-3-8B, GQA): B 1 at T 2048, q, k and v all contiguous
# (repeat_interleave makes k and v new tensors)
# the tensor-parallel runs' shapes: (s1)'s B 2 at H 6 (q, k, v views of the
# rank's [d, 3, d/2] projection: a T stride of 2,304 bytes), (t)'s B 2 at H
# 16, (u)'s B 1 at H 16 from 4 kv heads at T 2048
# the pipelined runs' microbatches: (z1)/(z2)'s B 1 at H 12, (z3)'s B 1 at H 6,
# (z4)'s B 1 at H 32 at T 2048 (run (k)'s shape)
FLASH_CASES = ((64, 8, 12, 1024, (1000,), "qkv", ((2, 6, 1024), (1, 12, 1024), (1, 6, 1024))),
               (128, 4, 32, 1024, (2048, 1000), "v", ((2, 32, 1024), (1, 32, 2048, ""),
                                                      (2, 16, 1024), (1, 16, 2048, ""))))
STEPS = 3
ACCUM = 2
EVAL_BATCHES = 2
N_LAYER = 12
LLAMA_LAYERS = 32   # Llama-2-7B at full depth in run (d)
EVAL_TOL = 0.002    # |eval loss through flash - through attention_xla|, both runs
STOCH_ARGS = ["--dropout", "0", "--max_grad_norm", "1.0"]   # run (e)
STOCH_MGN, STOCH_SEED, B1 = 1.0, 42, 0.9   # run (e)'s quantizer: run_clm's seed and beta1
STOCH_SIGMAS = 6   # the unbiasedness bound of run (e)'s ballot check
W4 = 4             # run (f): ranks sharing cuda:0 in a gloo group
W4_LAYERS = 2      # the (f) spawn's GPT-2 runs: GPT-2 124M's widths cut to 2 layers
W4_GPT2 = f"GPT-2 124M's widths at {W4_LAYERS} layers"
N_W4 = W4_LAYERS * 7_087_872 + 39_385_344   # their window: 53,561,088 coordinates
CHUNK_STEPS = 8    # [chunk]: run (c) in chunks of CHUNK_K steps and step by step
CHUNK_K = 4
GEN_LENS = (32, 96, 160, 224, 288, 352, 416, 512)   # [generate]: a left-padded batch's prompts
GEN_NEW = 128      # new tokens a row
GEN_LLAMA_LAYERS = 2   # Llama-3-8B's widths, cut to 2 layers
GEN_FILE_PROMPTS = ("The answer is", "Once upon a time", "Q: what is Lion? A:")
GEN_DEVICE = "cuda"   # where [generate] runs
SERVE_GEOM = dict(max_seqs=8, block_size=16, max_blocks_per_seq=64, num_blocks=512)
SERVE_LENS = tuple(range(32, 513, 32))   # [serve]: 16 requests' prompt lengths
SERVE_ARRIVE_EVERY = 3   # request i becomes visible at engine tick 3·i
SERVE_NEW = 64           # greedy tokens a request
SERVE_PREFIX = 256       # the shared prefix of the prefix-cache run, and each prompt's
SERVE_SUFFIX = 16        # own suffix: SERVE_SUFFIX·(1 + i % 8) tokens
SERVE_DUPLICATES = (0, 5)   # prefix-cache run: these prompts again, whole (a copy-on-write
# of the shared last page, the prompt's last token re-prefilled)
SERVE_PAGED_STEPS = 8    # greedy steps of the paged-against-dense check
F32_REL = 2 ** -12       # a float32-compute engine's logits against the float32 forward,
# relative to max|f32| (the prefix-cache runs)
SERVE_LLAMA_LAYERS = 2   # Llama-3-8B's widths, cut to 2 layers, through run_serve.main
SERVE_LLAMA, SERVE_LLAMA_VOCAB = "llama3_8b", 128_256
SERVE_LLAMA_GEOM = ["--max_seqs", "8", "--block_size", "16", "--max_blocks_per_seq", "32"]
SERVE_LLAMA_LENS = (16, 40, 64, 100, 128, 180, 200, 250)
SERVE_LLAMA_NEW = 16
SERVE_DEVICE = "cuda"    # where [serve] runs
MIXED_BUCKETS = 3  # [mixed]: GPT-2 124M's leaves as a mixed-dtype tree, voted in 3 buckets
MIXED_WD = 0.1
MIXED_DEVICE = "cuda"   # where [mixed] runs
W4_STEPS = 2
COMMIT_POLL_S = 60.0   # run (f)'s async commit at W4: the bounded wait for COMMITTED
LAZY_K, LAZY_STEPS = 4, 5   # runs (h1) and (f)'s lazy entry: a rotation and one slot more
# run (f)'s wires: (wire, extra flags, steps); gloo runs all of them on CUDA
# tensors (all_reduce, all_gather_into_tensor, all_to_all_single)
# run (m), the vote guard, rides the same spawn: (m1) enforce with every rank
# healthy, (m2) rank 1's grads NaN from step 1 (quarantined, readmitted,
# quarantined again), (m3) rank 2 an inverted voter, quarantined after one
# strike, so step 3 votes on the masked tally
M2_POISON, M2_STEPS = "nan_grads:1:1", 8
M2_ARGS = ["--vote_guard", "enforce", "--nan_sentinel", "--inject_poison", M2_POISON,
           "--guard_strikes", "2", "--guard_cooldown", "3"]
# (step, quarantined, readmitted) of (m2), as tests/test_torch_vote_guard.py
# pins them against the JAX trainer
M2_EVENTS = [[3, [1], []], [6, [], [1]], [8, [1], []]]
M3_ARGS = ["--vote_guard", "enforce", "--inject_poison", "flipped_ballot:2",
           "--guard_strikes", "1"]
W4_RUNS = (("sign_psum", [], W4_STEPS), ("sign_psum", ["--max_grad_norm", "1.0"], W4_STEPS),
           ("packed_a2a", [], W4_STEPS), ("hier:2", [], W4_STEPS),
           ("packed_a2a", ["--vote_every", str(LAZY_K)], LAZY_STEPS),
           ("packed_a2a", ["--vote_guard", "enforce"], W4_STEPS),
           ("packed_a2a", M2_ARGS, M2_STEPS), ("sign_psum", M3_ARGS, 3))
# run (p), the control plane and the run journal, rides the same spawn:
# sign_psum, rank 1 dropped at boundary 2 and rejoined at 5, on probation
# for 2 steps, every rank journaling into P_JOURNAL under the script's tmp
P_STEPS = 8
P_SPEC = "worker_drop:1:2,worker_rejoin:1:5"
P_ARGS = ["--wire", "sign_psum", "--control_plane", "--rejoin_probe_steps", "2",
          "--inject_membership", P_SPEC, "--journal", "--max_steps", str(P_STEPS)]
P_JOURNAL = "p_journal"
# rank 1's lifecycle after each boundary of (p) (the membership boundary
# before step s + 1, s = 0..7; the guard's fold of step s, s = 1..8), as
# tests/test_torch_control_plane.py pins the plane on this schedule against
# the JAX package's; and the voters of each step's election
P_LIFECYCLE = {"_apply_membership": ["healthy", "healthy", "departed", "departed", "departed",
                                     "rejoining", "rejoining", "rejoining"],
               "_apply_guard": ["healthy", "departed", "departed", "departed", "rejoining",
                                "rejoining", "healthy", "healthy"]}
P_VOTERS = [4, 4, 3, 3, 3, 4, 4, 4]
# the deduplicated membership timeline of the four journals
P_TIMELINE = [("worker_left", 2, 1), ("worker_rejoined", 5, 1), ("healthy", 7, 1)]
P_COVERAGE = 0.95
# the synchronizing CUDA runtime calls counted in run (c-journal)'s profiled
# steps, and the device-to-host copies
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
W4_ARGS = ["--model_name", "gpt2_124m", "--dataset", "synthetic", "--synthetic_blocks", "64",
           "--lion", "--async_grad", "--per_device_train_batch_size", "2",
           "--gradient_accumulation_steps", "1", "--block_size", "1024",
           "--max_steps", str(W4_STEPS), "--logging_steps", "1", "--dropout", "0", "--telemetry",
           "--lr_scheduler_type", "constant"]
# run (q), the cross-step DCN pipeline, rides the same spawn: (q1) hier:2 at
# depth 2 under the guard and (f)'s telemetry, (q2) lazy refresh at depth 1,
# (q3) the dcn_delay link at Q3_DELAY s, (q1)'s setup against its depth-0 twin
Q1_ARGS = ["--wire", "hier:2", "--dcn_pipeline_depth", "2", "--vote_guard", "enforce"]
Q1_STEPS = 6
Q2_ARGS = ["--wire", "hier:2", "--vote_every", str(LAZY_K), "--dcn_pipeline_depth", "1"]
Q2_STEPS = 5
Q3_DELAY = 1.0
Q3_RUNS = ((2, 4), (0, 3))   # (depth, steps)
Q1_SLOT_ONE_BUCKET = 6_695_138   # hier_ring_slot_bytes(N_W4, 4, 2) at one bucket
# run (r), ZeRO-1 AdamW in the same spawn: (f)'s setup without Lion and telemetry
R_ARGS = [a for a in W4_ARGS if a not in ("--lion", "--async_grad", "--telemetry")] + [
    "--lion", "false", "--async_grad", "false", "--zero1"]
R_STEPS = 3
# runs (s1), (s2), (t), (u): tensor parallelism in the same spawn, dp 2 x tp 2
# (global rank r: data rank r // 2, tensor rank r % 2), S_STEPS steps each;
# the LoRA runs (t) and (x1) LORA_STEPS, their dp check at the last step
TP, S_STEPS, LORA_STEPS = 2, 2, 3
S1_ARGS = ["--model_name", "gpt2_124m", "--dataset", "synthetic", "--synthetic_blocks", "64",
           "--lion", "--async_grad", "--wire", "sign_psum", "--per_device_train_batch_size",
           "2", "--gradient_accumulation_steps", "1", "--block_size", "1024",
           "--max_steps", str(S_STEPS), "--logging_steps", "1", "--dropout", "0",
           "--lr_scheduler_type", "constant", "--tensor_parallel", str(TP)]
S2_ARGS = S1_ARGS + ["--tp_vocab", "--vocab_pad_multiple", "64"]
S_EVAL = 1   # (s1), (s2): 3 held-out blocks over 2 data ranks, one eval batch
# (t): Llama-2-7B's widths and vocabulary, the depth cut to T_LAYERS
T_MODEL, T_LAYERS, T_VOCAB = "llama2_7b", 4, 32_000
T_ARGS = ["--model_name", T_MODEL, "--quant", "nf4", "--attn_impl", "flash",
          "--seq_length", "1024", "--per_device_train_batch_size", "2",
          "--gradient_accumulation_steps", "1", "--max_steps", str(LORA_STEPS),
          "--logging_steps", "1", "--lion", "--async_grad", "--wire", "sign_psum",
          "--tensor_parallel", str(TP),
          "--per_device_eval_batch_size", "2", "--eval_iters", "1"]
T_LORA = dict(r=8, alpha=16, dropout=0.05)   # run_sft's defaults
# (u): Llama-3-8B's widths, the depth cut to U_LAYERS, the head split by vocabulary
U_LAYERS, U_T = 2, 2048
U_ARGS = ["--model_family", "llama", "--model_name", "llama3_8b", "--param_dtype", "bfloat16",
          "--compute_dtype", "bfloat16", "--dropout", "0", "--block_size", str(U_T),
          "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "1",
          "--max_steps", str(S_STEPS), "--logging_steps", "1", "--dataset", "synthetic",
          "--synthetic_blocks", "16", "--lion", "--async_grad", "--wire", "sign_psum",
          "--lr_scheduler_type", "constant", "--tensor_parallel", str(TP), "--tp_vocab"]
# each rank's flat coordinates (reckoned from the leaf shapes): GPT-2 124M at
# tp 2 (the 50,257-row table replicated; with --tp_vocab half of 50,304
# padded rows), (t)'s adapters (A [4096, 8] whole, B [8, 2048] a rank, on
# wq and wv of 4 blocks), (u)'s Llama-3-8B slices (wte whole, half the
# lm_head, half of each block's projections)
N_TP = W4_LAYERS * 3_546_240 + 39_385_344   # 46,477,824 a rank
N_TP_VOCAB = 27_197_184   # (s2): wte split by its 50,304 padded rows
N_TP_SFT = T_LAYERS * 2 * (4096 * 8 + 8 * 2048)
N_TP_LLAMA3 = 525_336_576 + 262_668_288 + 4096 + U_LAYERS * 109_060_096
# runs (v1)-(x2): sequence parallelism in the same spawn, S_STEPS steps each
# ((x1) LORA_STEPS)
# (global rank r = (d·tp + t)·sp + s)
SP = 2
# (v1)-(v3) at float32 compute: their dp check holds the ring to the unsplit
# model within MEDIAN_TOL_F32, where bfloat16 rounding would blur it
V_BASE = S1_ARGS[:-2] + ["--compute_dtype", "float32"]   # (s1) without its tensor axis
V1_ARGS = V_BASE + ["--seq_parallel", str(SP), "--telemetry"]
V2_ARGS = V_BASE + ["--seq_parallel", str(SP), "--seq_impl", "ulysses"]
V3_ARGS = S1_ARGS + ["--compute_dtype", "float32", "--seq_parallel", str(SP)]
# (w): Llama-3-8B's widths at W_LAYERS layers, T 8192 over four seq ranks
W_LAYERS, W_T, W_SP, W_CHUNKS = 2, 8192, 4, 8
W_ARGS = ["--model_family", "llama", "--model_name", "llama3_8b", "--param_dtype", "bfloat16",
          "--compute_dtype", "bfloat16", "--dropout", "0", "--block_size", str(W_T),
          "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "1",
          "--max_steps", str(S_STEPS), "--logging_steps", "1", "--dataset", "synthetic",
          "--synthetic_blocks", "16", "--lion", "--async_grad", "--wire", "sign_psum",
          "--lr_scheduler_type", "constant", "--seq_parallel", str(W_SP), "--vocab_chunks",
          str(W_CHUNKS)]
# (x1): run_sft at Llama-2-7B's widths and vocabulary, X1_LAYERS layers, T
# 2048; no adapter dropout, whose masks would differ by chunk from the
# unsplit model's; (x2): run_dpo at X2_LAYERS layers, T 1024
X1_LAYERS, X2_LAYERS = 4, 2
X1_ARGS = ["--model_name", T_MODEL, "--quant", "nf4", "--packing", "--seq_length", "2048",
           "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1",
           "--max_steps", str(LORA_STEPS), "--logging_steps", "1", "--lion", "--async_grad",
           "--wire", "sign_psum", "--seq_parallel", str(SP), "--lora_dropout", "0",
           "--per_device_eval_batch_size", "2", "--eval_iters", "1"]
X2_ARGS = ["--model_name", T_MODEL, "--quant_ref", "nf4", "--max_length", "1024",
           "--max_prompt_length", "512", "--num_train_samples", "64", "--size_valid_set", "8",
           "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "1",
           "--max_steps", str(S_STEPS), "--logging_steps", "1", "--lion", "--async_grad",
           "--wire", "sign_psum", "--seq_parallel", str(SP), "--eval_iters", "1",
           "--per_device_eval_batch_size", "1"]
# each rank's flat coordinates: (w)'s whole Llama-3-8B at 2 layers (dp 1 x
# sp 4: nothing split), (x1)'s adapters (A [4096, 8], B [8, 4096] on wq and
# wv), (x2)'s DPO adapters (run (j)'s sites at X2_LAYERS layers)
N_SP_LLAMA3 = 2 * 525_336_576 + 4096 + W_LAYERS * 218_112_000
N_SP_SFT = X1_LAYERS * 2 * (4096 * 8 + 8 * 4096)
N_SP_DPO = X2_LAYERS * (4 * 2 * 4096 * 8 + 3 * (4096 * 8 + 8 * 11008)) + 259 * 8 + 8 * 4096
# runs (y1)-(y3): GPT-2-MoE at GPT-2 124M's widths and depth, 8 experts in
# every second block at capacity factor 1.25, on sign_psum at dropout 0. (y1)
# one rank in the slice phase, (b)'s setup with --telemetry; (y2) dp 2 x ep 2
# and (y3) dp 1 x tp 2 x ep 2 in the W4 spawn (global rank r = ((d·tp + t)·sp
# + s)·ep + e), B 2 x 1. (y2) at float32 compute and capacity factor 8
# (nothing drops, so the step-1 momentum is the unsplit model's), the tallies
# summed in the forward (--ep_dcn_pipeline 0); (y3) bfloat16, the ring at
# depth 2, Y3_STEPS steps
MOE_ARGS = ["--moe_experts", "8", "--moe_every", "2", "--moe_capacity_factor", "1.25"]
MOE_E = 8
Y1_ARGS = ["--dropout", "0", "--telemetry", *MOE_ARGS]
Y2_ARGS = V_BASE + MOE_ARGS + ["--moe_capacity_factor", "8", "--expert_parallel", "2",
                               "--ep_dcn_pipeline", "0"]
Y3_STEPS = 5
Y3_ARGS = S1_ARGS + MOE_ARGS + ["--expert_parallel", "2", "--ep_dcn_pipeline", "2",
                                "--max_steps", str(Y3_STEPS)]
Y3_DEPTH = 2
Y_LANES = 2 * 2 * 1024   # a MoE block's tallied lanes a step in (y3): ep x B x T
# each rank's coordinates: (y1) the whole model (124,439,808 - 6 dense MLPs of
# 4,722,432 + 6 MoE FFNs of 37,785,600), (y2) half of each FFN's experts, (y3)
# half of those experts' d_ff and the tensor slices of (s1) at full depth
N_MOE = 322_818_816
N_EP = 209_480_448
N_EP_TP = 124_485_888
MOE_DTYPES = {N_MOE: ((torch.float32, torch.float32),),
              N_EP: ((torch.float32, torch.float32),)}
# runs (z1)-(z4): pipeline parallelism in a W4 spawn of its own (global rank r
# = (((d·tp + t)·sp + s)·pp + p)·ep + e), Z_STEPS steps each on sign_psum at
# dropout 0 and bfloat16 compute: (z1) GPT-2 124M at dp 2 x pp 2, 4
# microbatches of B 4; (z2) dp 1 x pp 4, 8 microbatches of B 8 (stages 1 and
# 2 neither embed nor take the loss); (z3) dp 1 x tp 2 x pp 2, 4 microbatches
# of B 4; (z4) run_clm --model_family llama at Llama-3-8B's widths cut to
# Z4_LAYERS layers (2 a stage), bfloat16 params, T 2048, --vocab_chunks 8, dp
# 2 x pp 2, 2 microbatches of B 2. One eval batch each (their held-out blocks
# fill one batch of every data rank)
Z_STEPS = 2
Z_BASE = ["--model_name", "gpt2_124m", "--dataset", "synthetic", "--synthetic_blocks", "200",
          "--lion", "--async_grad", "--wire", "sign_psum", "--gradient_accumulation_steps", "1",
          "--block_size", "1024", "--max_steps", str(Z_STEPS), "--logging_steps", "1",
          "--dropout", "0", "--lr_scheduler_type", "constant", "--eval_iters", "1"]


def z_args(pp: int, micro: int, batch: int, extra=()) -> list:
    return Z_BASE + ["--pipeline_parallel", str(pp), "--pipeline_microbatches", str(micro),
                     "--per_device_train_batch_size", str(batch),
                     "--per_device_eval_batch_size", str(batch), *extra]


Z1_ARGS = z_args(2, 4, 4)
Z2_ARGS = z_args(4, 8, 8)
Z3_ARGS = z_args(2, 4, 4, ("--tensor_parallel", "2"))
Z4_LAYERS, Z4_T = 4, 2048
Z4_ARGS = ["--model_family", "llama", "--model_name", "llama3_8b", "--param_dtype", "bfloat16",
           "--compute_dtype", "bfloat16", "--dropout", "0", "--block_size", str(Z4_T),
           "--per_device_train_batch_size", "2", "--per_device_eval_batch_size", "2",
           "--gradient_accumulation_steps", "1", "--max_steps", str(Z_STEPS), "--logging_steps",
           "1", "--dataset", "synthetic", "--synthetic_blocks", "80", "--lion", "--async_grad",
           "--wire", "sign_psum", "--lr_scheduler_type", "constant", "--vocab_chunks", "8",
           "--pipeline_parallel", "2", "--eval_iters", "1"]
Z_LAYERS = 4   # (z1)-(z3): GPT-2 124M's widths cut to 4 blocks
# each rank's coordinates: a stage's blocks (GPT-2 124M's are 7,087,872 each,
# 3,546,240 a tensor rank's) and the replicated wte, wpe and ln_f
# (39,385,344); (z4) 2 of Llama-3-8B's blocks, wte, lm_head and ln_f: (w)'s
# window
N_PP = Z_LAYERS // 2 * 7_087_872 + 39_385_344
N_PP4 = Z_LAYERS // 4 * 7_087_872 + 39_385_344
N_PP_TP = Z_LAYERS // 2 * 3_546_240 + 39_385_344
N_PP_LLAMA3 = N_SP_LLAMA3
PP_DTYPES = {n: ((torch.float32, torch.float32),) for n in (N_PP, N_PP4, N_PP_TP)}
TP_DEVICE = "cuda"   # where (t)'s whole base is made
MEDIAN_COORDS = 1 << 24   # the coordinates a leaf's median ratio is taken over, at most
MEDIAN_TOL = 1e-2   # dp x tp == dp: per-leaf median momentum ratio (tests/test_tp_vocab.py)
MEDIAN_TOL_F32 = 1e-3   # the same at float32 compute
PLAIN_APPLY_MAX = 200_000_000   # coordinates up to which the watch re-applies in plain ops
HASH_CHUNK = 1 << 28   # bytes a seq-equality hash copies to the host at a time
RUNS = 25
AHEAD_CYCLES = 50_000_000   # about 30 ms of the card's clock: the host queues the timed calls

# data-sheet HBM bandwidth (bytes/s), dense bfloat16 tensor rate and float32
# rate outside the tensor cores (FLOP/s)
CARDS = [("H200", 4.8e12, 989e12, 67e12), ("H100 PCIe", 2.0e12, 756e12, 51e12),
         ("H100 NVL", 3.9e12, 835e12, 60e12), ("H100", 3.35e12, 989e12, 67e12)]

CUDA_SOURCES = ("flash_attention", "vote_stats")   # csrc/<name>.cu
# the kernels redesigned for Hopper (TMA ring, wgmma), each instantiation by
# its mangled template argument: their SASS must show both, and mma.sync
# nowhere
HOPPER_KERNELS = tuple(f"flash_{k}_kernelILi{d}E" for d in (64, 128)
                       for k in ("fwd", "bwd_dkv", "bwd_dq"))
DI_KERNELS = tuple(f"flash_di_kernelILi{d}E" for d in (64, 128))   # no wgmma, no TMA
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")
PROFILE_TOP = 10
GUARD_TOP = 8      # the kernels printed for each profiled [modes] step

FLASH = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
         "flash_attention_di")
# one entry per kernel instantiation: the hd64 flash kernels keep their
# names, the hd128 ones carry the suffix
# the optimizer kernels' entries: the bf16-momentum instantiations under
# float32 params carry the suffix
OPT_KERNELS = ("fused_ballots", "fused_apply", "bucket_vote_stats", "fused_ballots_mom_bf16",
               "fused_apply_mom_bf16", "fused_ballots_p_bf16", "fused_apply_p_bf16")
KERNELS = (*OPT_KERNELS, *FLASH, *(f"{k}_hd128" for k in FLASH))
# (params, momentum) dtypes the kernel phase holds the optimizer kernels at
MOM_BF16 = (torch.float32, torch.bfloat16)
DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), MOM_BF16)
# the tensor-parallel runs' windows, at their runs' dtypes
TP_DTYPES = {N_TP: ((torch.float32, torch.float32),),
             N_TP_VOCAB: ((torch.float32, torch.float32),),
             N_TP_SFT: ((torch.float32, torch.float32),),
             N_TP_LLAMA3: ((torch.bfloat16, torch.bfloat16),)}
# the sequence-parallel runs' windows ((v1), (v2) vote N_MAIN, (v3) N_TP)
# the (f) spawn's GPT-2 runs' window ((f), (m), (p), (q), (r), (v1), (v2))
W4_DTYPES = {N_W4: ((torch.float32, torch.float32),)}
SP_DTYPES = {N_SP_LLAMA3: ((torch.bfloat16, torch.bfloat16),),
             N_SP_SFT: ((torch.float32, torch.float32),),
             N_SP_DPO: ((torch.float32, torch.float32),)}
# the optimizer kernels' wrappers count in ``.launches``; the flash
# wrappers per head_dim in ``.by_head_dim``
WRAPPERS = {"fused_ballots": fused_lion.fused_ballots, "fused_apply": fused_lion.fused_apply,
            "bucket_vote_stats": fused_lion.bucket_vote_stats}
BY_DTYPE = ("fused_ballots", "fused_apply")   # the wrappers that count by momentum dtype
FLASH_WRAPPERS = {"flash_attention_fwd": fa.flash_attention_fwd,
                  "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                  "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                  "flash_attention_di": fa.flash_attention_di}
ROUTES = {
    "fused_ballots": ("triton", "distributed_lion_tpu_torch/ops/fused_lion.py",
                      "distributed_lion_tpu/ops/pallas_lion.py:84"),
    "fused_apply": ("triton", "distributed_lion_tpu_torch/ops/fused_lion.py",
                    "distributed_lion_tpu/ops/pallas_lion.py:118"),
    "bucket_vote_stats": ("cuda", "distributed_lion_tpu_torch/csrc/vote_stats.cu",
                          "distributed_lion_tpu/ops/pallas_lion.py:233"),
    "flash_attention_fwd": ("cuda", "distributed_lion_tpu_torch/csrc/flash_attention.cu",
                            "jax/experimental/pallas/ops/tpu/flash_attention.py:589"),
    "flash_attention_bwd_dkv": ("cuda", "distributed_lion_tpu_torch/csrc/flash_attention.cu",
                                "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
    "flash_attention_bwd_dq": ("cuda", "distributed_lion_tpu_torch/csrc/flash_attention.cu",
                               "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
    "flash_attention_di": ("cuda", "distributed_lion_tpu_torch/csrc/flash_attention.cu",
                           "jax/experimental/pallas/ops/tpu/flash_attention.py:273 "
                           "(di in jnp between the pallas_calls, not a pallas_call)"),
}
ROUTES.update({f"{k}_hd128": ROUTES[k] for k in FLASH})
ROUTES.update({f"{k}_{sfx}": ROUTES[k] for k in ("fused_ballots", "fused_apply")
               for sfx in ("mom_bf16", "p_bf16")})


def reset_counts() -> None:
    """Every kernel wrapper's launch counts to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for k in BY_DTYPE:
        WRAPPERS[k].by_dtype = {}
    fa.reset_counts()


def read_counts() -> dict:
    """Launches per entry of KERNELS."""
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    for k, fn in FLASH_WRAPPERS.items():
        counts[k] = fn.by_head_dim[64]
        counts[f"{k}_hd128"] = fn.by_head_dim[128]
    return counts


def split_counts(p_bf16: bool) -> dict:
    """The launches since ``reset_counts`` per entry of KERNELS, the ballot
    and apply kernels split by the momentum dtype they ran on
    (``.by_dtype``): float32 is the plain entry, bfloat16 the ``_p_bf16``
    one where the run's bfloat16 momenta sit under bfloat16 params
    (``p_bf16``), else the ``_mom_bf16`` one."""
    out = dict.fromkeys(KERNELS, 0)
    out.update(read_counts())
    for k in BY_DTYPE:
        by = WRAPPERS[k].by_dtype
        out[k] = by.get("float32", 0)
        out[k + ("_p_bf16" if p_bf16 else "_mom_bf16")] = by.get("bfloat16", 0)
    return out


def restore_counts(counts: dict) -> None:
    """Every launch count back to ``counts`` (``read_counts``'s): a check's
    own launches taken back out of a main path's run."""
    for name, fn in WRAPPERS.items():
        fn.launches = counts[name]
    for k, fn in FLASH_WRAPPERS.items():
        fn.by_head_dim[64], fn.by_head_dim[128] = counts[k], counts[f"{k}_hd128"]


def card_rates(name: str) -> tuple[float, float, float]:
    """(bytes/s, bfloat16 tensor FLOP/s, float32 FLOP/s) of the card."""
    for key, *rates in CARDS:
        if all(part in name for part in key.split()):
            return tuple(rates)
    raise RuntimeError(f"no data-sheet rates known for {name!r}")


def time_ms(fn, runs=RUNS) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` launches, after three
    warm-up calls; the card sleeps while the host queues them."""
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(runs)]
    torch.cuda._sleep(AHEAD_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def time_fresh_ms(setup, fn, runs=RUNS) -> tuple[float, float]:
    """(median, minimum) CUDA-event time of ``fn(setup())`` over ``runs``
    calls, each after its own ``setup()``, which is not timed (its work is
    queued before the start event, and the card sleeps while the host
    queues the call), after three warm-up calls."""
    for _ in range(3):
        fn(setup())
    times = []
    for _ in range(runs):
        arg = setup()
        torch.cuda._sleep(AHEAD_CYCLES // 16)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in times]
    return statistics.median(ms), min(ms)


def bound(nbytes: float, flops: float, rates, tensor: bool = True) -> tuple[float, str]:
    """(least ms, what bounds it) for ``nbytes`` moved and ``flops`` done,
    bfloat16 on the tensor cores or, with ``tensor=False``, float32 outside
    them."""
    bw, peak = rates[0], rates[1] if tensor else rates[2]
    t_bytes, t_ops = 1e3 * nbytes / bw, 1e3 * flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_cuda_kernels() -> dict:
    """Build the CUDA libraries, one ``nvcc`` per source, all started
    together; check every kernel's spills and the Hopper kernels' SASS.
    Returns :func:`cuda_build.sass_registers` of the flash kernels."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        libs = list(pool.map(lambda name: cuda_build.build(cuda_build.CSRC / f"{name}.cu"),
                             CUDA_SOURCES))
    print(f"[build] {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for lib in libs:
        log = lib.with_suffix(".log").read_text()
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "warning" in line):
                print(f"[build] {line.strip()}", flush=True)
        spills = cuda_build.ptxas_spills(log)
        if not spills or any(v != (0, 0) for v in spills.values()):
            raise AssertionError(f"{lib.name}: spill bytes (stores, loads) {spills} in the ptxas "
                                 "report, expected (0, 0) for every function")
    flash = libs[CUDA_SOURCES.index("flash_attention")]
    log = flash.with_suffix(".log").read_text()
    serialized = {f: why for f, why in cuda_build.ptxas_serialized(log).items()
                  if any(kernel in f for kernel in HOPPER_KERNELS)}
    if serialized:
        raise AssertionError(f"ptxas serializes the wgmma of {serialized}")
    spills = cuda_build.ptxas_spills(log)
    for kernel in HOPPER_KERNELS + DI_KERNELS:
        if len([name for name in spills if kernel in name]) != 1:
            raise AssertionError(f"{kernel}: not one entry in the ptxas report {list(spills)}")
    sass = cuda_build.sass_of(flash)
    counts = cuda_build.count_sass(sass, HOPPER_KERNELS, SASS_OPS)
    regs = cuda_build.sass_registers(sass, HOPPER_KERNELS)
    for kernel, ops in counts.items():
        used, sets = regs[kernel]
        print(f"[sass] {kernel}: " + ", ".join(f"{op} {n}" for op, n in ops.items())
              + f"; registers used {used}, setmaxnreg {sets}", flush=True)
        if ops["HGMMA"] == 0 or ops["UTMALDG"] == 0 or ops["HMMA"] != 0:
            raise AssertionError(f"{kernel}: SASS {ops}: expected wgmma (HGMMA) and TMA loads "
                                 "(UTMALDG), and no mma.sync (HMMA)")
    return regs


def optimizer_kernel_phase(gen, rates, ns=(N_MAIN, N_SFT, N_DPO, N_RAGGED, *W4_DTYPES,
                                           *TP_DTYPES, *SP_DTYPES, *MOE_DTYPES, *PP_DTYPES),
                           big: bool = True):
    """Compare and time the two Triton kernels and the stats kernel at each
    window of ``ns`` (and with ``big`` the 2³¹ + 4097 window); returns
    per-kernel records at the main path's shape (float32, int8 tally) and
    the max error over all cases."""
    rec = {}
    err = dict.fromkeys(OPT_KERNELS, 0.0)
    for n in dict.fromkeys(ns):   # a window two runs share is checked once
        for pdt, mdt in {**W4_DTYPES, **TP_DTYPES, **SP_DTYPES, **MOE_DTYPES,
                         **PP_DTYPES}.get(n, DTYPE_PAIRS):
            if (pdt, mdt) == MOM_BF16 and n in (N_SFT, N_DPO):
                continue   # bf16 momentum under float32 params: GPT-2's run (h2)
            suffix = {MOM_BF16: "_mom_bf16", (torch.bfloat16, torch.bfloat16): "_p_bf16"}.get(
                (pdt, mdt), "")
            g = torch.randn(n, generator=gen, device="cuda").to(mdt)
            m = torch.randn(n, generator=gen, device="cuda").to(mdt)
            p = torch.randn(n, generator=gen, device="cuda").to(pdt)
            lr = torch.tensor(3e-4, device="cuda")
            mb = m.element_size()

            ballots = fused_lion.fused_ballots(g, m, 0.9)
            plain = fused_lion.fused_ballots_plain(g, m, 0.9)
            torch.cuda.synchronize()
            if not torch.equal(ballots, plain):
                raise AssertionError(f"fused_ballots != plain at n={n} {mdt}: "
                                     f"{(ballots != plain).sum().item()} differ")
            err["fused_ballots" + suffix] = max(err["fused_ballots" + suffix],
                                                (ballots.int() - plain.int()).abs().max().item())
            ms = time_ms(lambda: fused_lion.fused_ballots(g, m, 0.9))
            plain_ms = time_ms(lambda: fused_lion.fused_ballots_plain(g, m, 0.9))
            bms, by = bound(n * (2 * mb + 1), 0, rates)
            print(f"[kernel] fused_ballots n={n} {str(mdt)[6:]}: {ms:.4f} ms "
                  f"(bound {bms:.4f} ms, plain {plain_ms:.4f} ms)", flush=True)
            if n == N_MAIN and mdt == pdt == torch.float32:
                rec["fused_ballots"] = (ms, plain_ms, bms, by, None)
            if n == N_MAIN and suffix:
                rec["fused_ballots" + suffix] = (ms, plain_ms, bms, by, None)

            for tdt in (torch.int8, torch.int32):
                tot = torch.randint(-3, 4, (n,), generator=gen, device="cuda",
                                    dtype=tdt)
                pk, mk = p.clone(), m.clone()
                fused_lion.fused_apply(pk, g, mk, tot, lr, 0.1, 0.99)
                pp, mp = fused_lion.fused_apply_plain(p, g, m, tot, lr, 0.1, 0.99)
                torch.cuda.synchronize()
                if not (torch.equal(pk, pp) and torch.equal(mk, mp)):
                    raise AssertionError(
                        f"fused_apply != plain at n={n} params {pdt} momentum {mdt} tally "
                        f"{tdt}: {(pk != pp).sum().item()} params, "
                        f"{(mk != mp).sum().item()} momenta differ")
                err["fused_apply" + suffix] = max(
                    err["fused_apply" + suffix],
                    (pk.float() - pp.float()).abs().max().item(),
                    (mk.float() - mp.float()).abs().max().item())
                del pp, mp
                ms = time_ms(lambda: fused_lion.fused_apply(pk, g, mk, tot, lr, 0.1, 0.99))
                plain_ms = time_ms(
                    lambda: fused_lion.fused_apply_plain(p, g, m, tot, lr, 0.1, 0.99))
                bms, by = bound(n * (2 * p.element_size() + 2 * mb + mb
                                     + tot.element_size()), 0, rates)
                print(f"[kernel] fused_apply n={n} params {str(pdt)[6:]} momentum "
                      f"{str(mdt)[6:]} tally {str(tdt)[6:]}: {ms:.4f} ms (bound {bms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms)", flush=True)
                if n == N_MAIN and tdt == torch.int8 and mdt == pdt == torch.float32:
                    rec["fused_apply"] = (ms, plain_ms, bms, by, None)
                if n == N_MAIN and tdt == torch.int8 and suffix:
                    rec["fused_apply" + suffix] = (ms, plain_ms, bms, by, None)
                del tot, pk, mk
            del g, m, p
            torch.cuda.empty_cache()

        if n in W4_DTYPES or not (n in TP_DTYPES or n in SP_DTYPES or n in PP_DTYPES
                                  or n == N_EP):   # no telemetry in those runs
            stats_cases(gen, rates, n, rec, err)
        torch.cuda.empty_cache()
    if big:
        big_window_check(gen, err)
    return rec, err


def big_window_check(gen, err) -> None:
    """``fused_ballots`` and ``fused_apply`` with p, g and m bfloat16 over one
    window of N_BIG = 2**31 + 4097 coordinates (run (k)'s 8.03B run them
    past int32 offsets): a slice straddling 2**31 and the window's tail
    held ``torch.equal`` to the plain version of the same slices (the plain
    pass over the whole window would need tens of GB of float32
    temporaries)."""
    n, bf = N_BIG, torch.bfloat16
    g = torch.randn(n, generator=gen, device="cuda", dtype=bf)
    m = torch.randn(n, generator=gen, device="cuda", dtype=bf)
    p = torch.randn(n, generator=gen, device="cuda", dtype=bf)
    tot = torch.randint(-1, 2, (n,), generator=gen, device="cuda", dtype=torch.int8)
    lr = torch.tensor(3e-4, device="cuda")
    ballots = fused_lion.fused_ballots(g, m, 0.9)
    pk, mk = p.clone(), m.clone()
    fused_lion.fused_apply(pk, g, mk, tot, lr, 0.1, 0.99)
    torch.cuda.synchronize()
    for lo in (2**31 - BIG_SLICE // 2, n - BIG_SLICE):
        w = slice(lo, lo + BIG_SLICE)
        plain = fused_lion.fused_ballots_plain(g[w], m[w], 0.9)
        pp, mp = fused_lion.fused_apply_plain(p[w], g[w], m[w], tot[w], lr, 0.1, 0.99)
        torch.cuda.synchronize()
        if not (torch.equal(ballots[w], plain) and torch.equal(pk[w], pp)
                and torch.equal(mk[w], mp)):
            raise AssertionError(
                f"bfloat16 kernels != plain on [{lo}, {lo + BIG_SLICE}) of a {n}-coordinate "
                f"window: {(ballots[w] != plain).sum().item()} ballots, "
                f"{(pk[w] != pp).sum().item()} params, {(mk[w] != mp).sum().item()} momenta")
        err["fused_ballots_p_bf16"] = max(err["fused_ballots_p_bf16"],
                                          (ballots[w].int() - plain.int()).abs().max().item())
        err["fused_apply_p_bf16"] = max(err["fused_apply_p_bf16"],
                                        (pk[w].float() - pp.float()).abs().max().item(),
                                        (mk[w].float() - mp.float()).abs().max().item())
        print(f"[kernel] fused_ballots, fused_apply n={n} params bfloat16 momentum bfloat16 "
              f"tally int8: [{lo}, {lo + BIG_SLICE}) == plain", flush=True)
    del g, m, p, tot, ballots, pk, mk
    torch.cuda.empty_cache()


def stats_check(label, ballots, tot, world, err) -> None:
    """``bucket_vote_stats`` against its plain version: ``torch.equal``."""
    hist, dis = fused_lion.bucket_vote_stats(ballots, tot, world, 8)
    hp, dp = fused_lion.bucket_vote_stats_plain(ballots, tot, world, 8)
    torch.cuda.synchronize()
    if not (torch.equal(hist, hp) and torch.equal(dis, dp)):
        raise AssertionError(f"bucket_vote_stats != plain at {label}: {hist.tolist()} "
                             f"{dis.item()} vs {hp.tolist()} {dp.item()}")
    err["bucket_vote_stats"] = max(err["bucket_vote_stats"], (hist - hp).abs().max().item(),
                                   abs(dis.item() - dp.item()))
    print(f"[kernel] bucket_vote_stats {label}: == plain; hist {hist.tolist()}, disagree "
          f"{dis.item()}", flush=True)


def stats_cases(gen, rates, n, rec, err) -> None:
    """The stats kernel at n coordinates: a vote of 1 (the smoke's: the
    tally is the ballots) and of 4 (tallies in {-4, -2, 0, 2, 4}), int8 and
    int32 tallies, timed; then untimed, a vote of 3 (a world that does not
    divide the 8 bins) and of 300 (int32 only: binned by division), and
    windows that start at an odd byte offset of a larger buffer, lined up
    (vector body) and not (every coordinate scalar)."""
    ballots = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1, -1
                          ).to(torch.int8)

    def tally(world, tdt, size=n):
        return torch.randint(-world, world + 1, (size,), generator=gen, device="cuda").to(tdt)

    for world, tdt in ((1, torch.int8), (4, torch.int8), (4, torch.int32)):
        tot = (ballots.clone() if world == 1 else
               2 * torch.randint(0, 5, (n,), generator=gen, device="cuda") - 4).to(tdt)
        label = f"n={n} W={world} tally {str(tdt)[6:]}"
        stats_check(label, ballots, tot, world, err)
        ms = time_ms(lambda: fused_lion.bucket_vote_stats(ballots, tot, world, 8))
        plain_ms = time_ms(lambda: fused_lion.bucket_vote_stats_plain(ballots, tot, world, 8))
        bms, by = bound(n * (1 + tot.element_size()), 0, rates)
        print(f"[kernel] bucket_vote_stats {label}: {ms:.4f} ms (bound {bms:.4f} ms, "
              f"{n * (1 + tot.element_size()) / ms / 1e6:.0f} GB/s, plain {plain_ms:.4f} ms)",
              flush=True)
        if n == N_MAIN and world == 4 and tdt == torch.int8:
            rec["bucket_vote_stats"] = (ms, plain_ms, bms, by, None)
        del tot
    for world, tdt in ((3, torch.int8), (3, torch.int32), (300, torch.int32)):
        stats_check(f"n={n} W={world} tally {str(tdt)[6:]}", ballots, tally(world, tdt), world,
                    err)
    big_b = torch.where(torch.rand(n + 64, generator=gen, device="cuda") < 0.5, 1, -1
                        ).to(torch.int8)
    for world, tdt in ((4, torch.int8), (4, torch.int32)):
        big_t = tally(world, tdt, n + 64)
        for b_off, t_off in ((7, 7), (3, 8)):
            stats_check(f"n={n} W={world} tally {str(tdt)[6:]} window at offsets "
                        f"{b_off}, {t_off}", big_b[b_off:b_off + n], big_t[t_off:t_off + n],
                        world, err)
        del big_t
    del ballots, big_b


def flash_inputs(gen, T, B, H, D, views):
    """q, k, v and do in the layout the model hands the kernels: the
    operands named in ``views`` transposed views of one [B, T, len(views),
    H * D] projection, the others contiguous [B, H, T, D]; do a transposed
    view of [B, T, H, D]."""
    proj = torch.randn(B, T, len(views), H * D, generator=gen, device="cuda").bfloat16()
    ops = {name: proj[:, :, i].reshape(B, T, H, D).transpose(1, 2)
           for i, name in enumerate(views)}
    for name in "qkv":
        if name not in ops:
            ops[name] = torch.randn(B, H, T, D, generator=gen, device="cuda").bfloat16()
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16().transpose(1, 2)
    return ops["q"], ops["k"], ops["v"], do


def flash_reference64(q, k, v, do):
    """o, lse, dq, dk, dv in float64 from the same bfloat16 inputs."""
    qd, kd, vd, dod = (x.double() for x in (q, k, v, do))
    T, scale = q.shape[2], 1.0 / math.sqrt(q.shape[-1])
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = (qd @ kd.transpose(-1, -2) * scale).masked_fill(~mask, -math.inf)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    del s
    o = p @ vd
    ds = p * (dod @ vd.transpose(-1, -2) - (o * dod).sum(-1)[..., None])
    out = {"o": o, "lse": lse, "dq": ds @ kd * scale, "dk": ds.transpose(-1, -2) @ qd * scale,
           "dv": p.transpose(-1, -2) @ dod}
    return out


def half_ulp_bf16(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 8)


def ulp_f32(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 23)


def flash_check(tag, name, got, plain, want) -> float:
    """Hold one output to the criterion of the module doc; returns its max
    difference from the plain version."""
    got, pl = got.double(), plain.double()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"flash {name} at {tag}: shape {tuple(got.shape)} "
                             f"or non-finite values")
    e_k = (got - want).abs().max().item()
    e_p = (pl - want).abs().max().item()
    top = want.abs().max().item()
    slack = 4 * ulp_f32(top) if name == "lse" else half_ulp_bf16(top)
    limit = 2 * e_p + slack
    vs_plain = (got - pl).abs().max().item()
    print(f"[flash] {tag} {name}: kernel err {e_k:.3e}, plain err {e_p:.3e}, "
          f"limit {limit:.3e} (max |value| {top:.3f}); kernel vs plain {vs_plain:.3e}",
          flush=True)
    if e_k > limit:
        raise AssertionError(f"flash {name} at {tag}: error {e_k} against float64 "
                             f"exceeds 2 x plain ({e_p}) + {slack}")
    return vs_plain


def di_check(tag, got, plain, o, do) -> float:
    """Hold ``di`` to the float64 sum of the same products, row by row:
    ``|got - f64| <= 2 |plain - f64| + D 2**-24 sum|o do|`` (the plain
    version's error, and the bound of a float32 sum of D terms in any
    order); returns its max difference from the plain version."""
    prod = o.double() * do.double()
    want, mag = prod.sum(-1), prod.abs().sum(-1)
    del prod
    if (got.dtype != torch.float32 or got.shape != want.shape or not got.is_contiguous()
            or not torch.isfinite(got).all()):
        raise AssertionError(f"flash di at {tag}: {got.dtype} {tuple(got.shape)}, contiguous "
                             f"{got.is_contiguous()}, or non-finite values")
    e_k, e_p = (got.double() - want).abs(), (plain.double() - want).abs()
    limit = 2 * e_p + o.shape[-1] * 2.0 ** -24 * mag
    over = int((e_k > limit).sum())
    vs_plain = (got - plain).abs().max().item()
    print(f"[flash] {tag} di: kernel err {e_k.max().item():.3e}, plain err "
          f"{e_p.max().item():.3e}, worst kernel err / row limit "
          f"{(e_k / limit.clamp_min(1e-300)).max().item():.3f} (max |value| "
          f"{want.abs().max().item():.3f}); kernel vs plain {vs_plain:.3e}", flush=True)
    if over:
        raise AssertionError(f"flash di at {tag}: {over} rows exceed 2 x plain + D 2^-24 "
                             "sum|o do| against float64")
    return vs_plain


def flash_kernel_phase(gen, rates, regs, D, B_main, H_main, T_main, T_more, views, more):
    """Check the flash kernels of head_dim D (forward, di, dK/dV, dQ) at
    every shape, with q, k, v in the model's layout (``views``: see
    flash_inputs) and at the (B, H, T) of ``more`` (a fourth entry: that
    shape's own ``views``); time them at the main
    one, and the port's whole backward
    (``flash_attention_di``, dK/dV and dQ) beside SDPA's. ``regs``:
    :func:`cuda_build.sass_registers` of the Hopper kernels. Records are
    named as in KERNELS."""
    suffix = "" if D == 64 else f"_hd{D}"
    rec = {}
    err = {k + suffix: 0.0 for k in FLASH}
    owner = {"o": "flash_attention_fwd", "lse": "flash_attention_fwd",
             "dk": "flash_attention_bwd_dkv", "dv": "flash_attention_bwd_dkv",
             "dq": "flash_attention_bwd_dq", "di": "flash_attention_di"}
    owner = {name: k + suffix for name, k in owner.items()}
    shapes = [(B_main, H_main, T) for T in (T_main, *T_more)] + list(more) + list(FLASH_SMALL)
    for B, H, T, *layout in shapes:
        tag = f"hd{D} B{B} H{H} T{T}" + (f" views {layout[0] or 'none'}" if layout else "")
        q, k, v, do = flash_inputs(gen, T, B, H, D, layout[0] if layout else views)
        o, lse = fa.flash_attention_fwd(q, k, v)
        op, lp = fa.flash_attention_fwd_plain(q, k, v)
        di = fa.attention_di(op, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lp, di)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lp, di)
        dkp, dvp = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lp, di)
        dqp = fa.flash_attention_bwd_dq_plain(q, k, v, do, lp, di)
        torch.cuda.synchronize()
        kern = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        plain = {"o": op, "lse": lp, "dq": dqp, "dk": dkp, "dv": dvp}
        ref = flash_reference64(q, k, v, do)
        for name, want in ref.items():
            err[owner[name]] = max(err[owner[name]],
                                   flash_check(tag, name, kern[name], plain[name], want))
        # the di kernel on the plain forward's o, against the float64 sum
        di_kern = fa.flash_attention_di(op, do)
        err[owner["di"]] = max(err[owner["di"]], di_check(tag, di_kern, di, op, do))
        # the forward kernel's own o and lse, the di kernel's di of them,
        # and the backward kernels on those, as training chains them
        di_k = fa.flash_attention_di(o, do)
        dk_k, dv_k = fa.flash_attention_bwd_dkv(q, k, v, do, lse, di_k)
        dq_k = fa.flash_attention_bwd_dq(q, k, v, do, lse, di_k)
        for name, got in (("dq", dq_k), ("dk", dk_k), ("dv", dv_k)):
            flash_check(tag, f"{name} (after the forward and di kernels)", got, plain[name],
                        ref[name])
        # the same inputs again: the same bits
        o2, lse2 = fa.flash_attention_fwd(q, k, v)
        di2 = fa.flash_attention_di(op, do)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lp, di)
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lp, di)
        torch.cuda.synchronize()
        again = {"o": (o, o2), "lse": (lse, lse2), "di": (di_kern, di2), "dk": (dk, dk2),
                 "dv": (dv, dv2), "dq": (dq, dq2)}
        differ = [name for name, (a, b) in again.items() if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"flash at {tag}: a second call differs in {differ}")
        print(f"[flash] {tag}: a second call gives the same bits in {list(again)}", flush=True)
        del ref, kern, plain, di_kern, di_k, dk_k, dv_k, dq_k, again, o2, lse2, di2, dk2, dv2, dq2
        if (B, H, T, *layout) != shapes[0]:
            del q, k, v, do, o, lse, op, lp, di, dk, dv, dq, dkp, dvp, dqp
            torch.cuda.empty_cache()
            continue

        pairs = B * H * T * (T + 1) / 2   # (q, k) pairs with k <= q
        elem = B * H * T * D * 2          # one bfloat16 [B, H, T, D] tensor
        row = B * H * T * 4               # one float32 [B, H, T] tensor
        cases = {
            "flash_attention_fwd" + suffix: (lambda: fa.flash_attention_fwd(q, k, v),
                                    lambda: fa.flash_attention_fwd_plain(q, k, v),
                                    4 * elem + row, 2 * 2 * D * pairs),
            "flash_attention_bwd_dkv" + suffix: (
                lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lp, di),
                lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lp, di),
                6 * elem + 2 * row, 4 * 2 * D * pairs),
            "flash_attention_bwd_dq" + suffix: (
                lambda: fa.flash_attention_bwd_dq(q, k, v, do, lp, di),
                lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, lp, di),
                5 * elem + 2 * row, 3 * 2 * D * pairs),
            # float32 multiply-adds outside the tensor cores: 2 D a row
            "flash_attention_di" + suffix: (
                lambda: fa.flash_attention_di(o, do), lambda: fa.attention_di(o, do),
                2 * elem + row, 2 * D * B * H * T),
        }
        ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_fwd, lib_fwd_min = time_fresh_ms(
            lambda: None, lambda _: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        lib_bwd, lib_bwd_min = time_fresh_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True),
            lambda out: torch.autograd.grad(out, (ql, kl, vl), do))
        lib_both = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(ql, kl, vl, is_causal=True), (ql, kl, vl), do))
        print(f"[library] scaled_dot_product_attention causal B{B} H{H} T{T} hd{D}: "
              f"forward {lib_fwd:.4f} ms (min {lib_fwd_min:.4f}), backward {lib_bwd:.4f} ms "
              f"(min {lib_bwd_min:.4f}; a fresh graph per call), forward + backward "
              f"{lib_both:.4f} ms", flush=True)
        tiles = fa.tiles(D)
        grid = "tile-major" if tiles["tile_major"] else "head-major"
        shape = {"flash_attention_fwd": f"{tiles['fwd_queries']} queries a block, key tiles of "
                                       f"{tiles['fwd_keys']}, K and V each in a ring of "
                                       f"{tiles['fwd_stages']} stages, blocks in groups of up to "
                                       f"{tiles['fwd_head_group']} heads, longest tiles first",
                 "flash_attention_bwd_dkv": f"{tiles['dkv_keys']} keys a block, query tiles of "
                                           f"{tiles['dkv_queries']}, {grid} grid",
                 "flash_attention_bwd_dq": f"{tiles['dq_queries']} queries a block, key tiles of "
                                          f"{tiles['dq_keys']}, {grid} grid"}
        for name, (kern_fn, plain_fn, nbytes, flops) in cases.items():
            ms, plain_ms = time_ms(kern_fn), time_ms(plain_fn)
            base = name.removesuffix(suffix)
            bms, by = bound(nbytes, flops, rates, tensor=base != "flash_attention_di")
            library = {"flash_attention_fwd": lib_fwd,
                       "flash_attention_di": None}.get(base, lib_bwd)
            extra = f"library {library:.4f} ms" if library is not None else "no library call"
            if base in shape:
                used, sets = regs[f"flash_{base.removeprefix('flash_attention_')}_kernelILi{D}E"]
                extra += (f"; {shape[base]}; registers: {used} used, setmaxnreg {sets} "
                          "(consumers, producer)")
            print(f"[kernel] {name} B{B} H{H} T{T} hd{D}: {ms:.4f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.0f} GB/s (bound "
                  f"{bms:.4f} ms by {by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; plain "
                  f"{plain_ms:.4f} ms; {extra})", flush=True)
            rec[name] = (ms, plain_ms, bms, by, library)

        def whole_backward():
            di_w = fa.flash_attention_di(o, do)
            fa.flash_attention_bwd_dkv(q, k, v, do, lse, di_w)
            fa.flash_attention_bwd_dq(q, k, v, do, lse, di_w)

        whole = time_ms(whole_backward)
        di_ms, di_plain_ms = rec["flash_attention_di" + suffix][:2]
        print(f"[library] backward B{B} H{H} T{T} hd{D}: the port's flash_attention_di + dK/dV + "
              f"dQ {whole:.4f} ms (flash_attention_di alone {di_ms:.4f} ms; its plain version "
              f"attention_di {di_plain_ms:.4f} ms), scaled_dot_product_attention's backward "
              f"{lib_bwd:.4f} ms: {whole / lib_bwd:.3f} x", flush=True)
        del ql, kl, vl, q, k, v, do, o, lse, op, lp, di, dk, dv, dq, dkp, dvp, dqp
        torch.cuda.empty_cache()
    return rec, err


def model_check():
    """A tiny float32 GPT-2's logits on the card against the CPU's."""
    cfg = GPT2Config.tiny(compute_dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cpu = GPT2(cfg, device="cpu", seed=3)(tokens)
        gpu = GPT2(cfg, device="cuda", seed=3)(tokens.cuda()).cpu()
    if gpu.shape != (2, 32, cfg.vocab_size) or not torch.allclose(gpu, cpu, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"tiny GPT-2 logits differ card vs CPU by "
                             f"{(gpu - cpu).abs().max().item()}")


def product_check(gen):
    """``matmul_f32`` on the card at the slice's shapes (one microbatch's
    tied head and attention scores, bfloat16 operands, values of a few
    units to a few tens, as GPT-2's logits reach) against float64 products
    of the same operands."""
    x = torch.randn(8, 1024, 768, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(768, 50257, generator=gen, device="cuda") * 0.1).bfloat16()
    q = torch.randn(8, 12, 1024, 64, generator=gen, device="cuda").bfloat16()
    k = torch.randn(8, 12, 64, 1024, generator=gen, device="cuda").bfloat16()
    for name, a, b in (("head", x, w), ("scores", q, k)):
        got = matmul_f32(a, b)
        want = torch.matmul(a.double(), b.double())
        err = (got.double() - want).abs().max().item()
        top = want.abs().max().item()
        if got.dtype != torch.float32 or err > 2.0 ** -12 * top:
            raise AssertionError(f"matmul_f32 {name}: {got.dtype}, max err {err} at max |value| {top}")
        print(f"[product] {name} {tuple(got.shape)}: max err {err:.3e} at max |value| {top:.2f}",
              flush=True)
        del got, want


def wire_check(gen):
    """Each flat wire over the 1-rank NCCL group: the tally of the rank's
    own card ballots is those ballots, and no byte crosses a link. Times
    ``sign_psum`` at the main path's size with the copy that keeps the
    ballots (telemetry on) and without it (in place)."""
    for n in (N_MAIN, N_RAGGED):
        ballots = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1, -1
                              ).to(torch.int8)
        for wire in ("sign_psum", "packed_allgather", "packed_a2a"):
            tally = collectives.WireTally()
            tot = collectives.vote_total(ballots, wire, dist.group.WORLD, tally,
                                         keep_ballots=True)
            if not (tot.is_cuda and tot.data_ptr() != ballots.data_ptr()
                    and torch.equal(tot.to(torch.int32), ballots.to(torch.int32))
                    and tally.total() == 0):
                raise AssertionError(f"wire {wire} at n={n}: the 1-rank tally is not "
                                     f"the ballots (bytes {tally.total()})")
            print(f"[wire] {wire} n={n}: 1-rank tally == ballots", flush=True)
            del tot
        if n == N_MAIN:
            group = dist.group.WORLD
            kept = time_ms(lambda: collectives.vote_total(ballots, "sign_psum", group,
                                                          keep_ballots=True))
            in_place = time_ms(lambda: collectives.vote_total(ballots, "sign_psum", group))
            print(f"[wire] sign_psum n={n}: {kept:.4f} ms keeping the ballots (a copy), "
                  f"{in_place:.4f} ms in place", flush=True)


def device_events(fn):
    """``torch.profiler`` over one call of ``fn``, device activity only
    (tracing the host's ops would slow the host): ``fn``'s result and the
    device events, [] where the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_table(device) -> list:
    """``[(name, (total us, calls))]`` of the device events, the largest
    total first."""
    per_name: dict = {}
    for e in device:
        total, calls = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (total + e.time_range.elapsed_us(), calls + 1)
    return sorted(per_name.items(), key=lambda kv: -kv[1][0])


def profile_step(trainer, model, gen, batch: int, label: str, rows=None, T: int = 1024) -> None:
    """``torch.profiler`` over one forward + backward microbatch of the
    trainer's loss (``batch`` x ``T`` random tokens of the model's
    vocabulary, or ``rows``, a batch the loss takes; dropout seed 0);
    prints the top device kernels and the idle share."""
    vocab = model.cfg.vocab_size
    tokens = (torch.randint(0, vocab, (batch, T), generator=gen, device="cuda")
              if rows is None else rows)

    def microbatch():
        loss, _ = trainer.loss_fn(tokens, 0)
        loss.backward()
        return loss

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        microbatch()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    loss, device = device_events(microbatch)
    if not device:
        print(f"[profile] {label}: torch.profiler recorded no device activity: kernel times and "
              "the idle share not measured", flush=True)
        return
    start = min(e.time_range.start for e in device)
    end = max(e.time_range.end for e in device)
    busy, reach = 0.0, start
    for e in sorted(device, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, reach), e.time_range.end
        if hi > lo:
            busy += hi - lo
            reach = hi
    window = end - start
    print(f"[profile] {label}: one forward + backward microbatch, B {batch} T {T}, loss "
          f"{loss.item():.4f}: window {window / 1e3:.3f} ms (first to last device event; "
          f"unprofiled microbatches {', '.join(f'{w:.3f}' for w in walls)} ms on the host "
          f"clock), device busy {busy / 1e3:.3f} ms, idle share {1 - busy / window:.4f}, "
          f"{len(device)} device events", flush=True)
    for rank, (name, (total, calls)) in enumerate(kernel_table(device), 1):
        if rank <= PROFILE_TOP or "flash_" in name:   # the top, and the port's flash kernels
            print(f"[profile] {label} #{rank:<3d} {total / 1e3:9.3f} ms {calls:5d} calls  "
                  f"{name[:110]}", flush=True)


SLICE_ARGS = ["--model_name", "gpt2_124m", "--dataset", "synthetic",
              "--lion", "--async_grad", "--wire", "auto",
              "--per_device_train_batch_size", "8", "--gradient_accumulation_steps", str(ACCUM),
              "--block_size", "1024", "--max_steps", str(STEPS), "--logging_steps", "1",
              "--synthetic_blocks", "400", "--per_device_eval_batch_size", "8",
              "--eval_iters", str(EVAL_BATCHES)]


def run_counted(extra, steps=STEPS):
    """One ``run_clm.main`` of ``steps`` steps with every kernel counter at
    0 before and read after; checks the losses and returns (trainer, rows,
    launches)."""
    reset_counts()
    trainer = run_clm.main(SLICE_ARGS + extra + ["--max_steps", str(steps)])
    launches = read_counts()
    rows = [r for r in trainer.history if "loss" in r]
    if len(rows) != steps or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"expected {steps} finite losses, got {rows}")
    return trainer, rows, launches


def optimizer_launches(trainer, steps: int) -> dict:
    """The optimizer kernels' launches in ``steps`` steps of ``trainer``'s
    optimizer: per vote bucket, or under ``vote_every`` K > 1 per bucket of
    the slot's slice that holds real coordinates (the ballot kernel at
    float32 momentum and deterministic ballots only), and one apply a step
    over the voted slots (float32 params and momentum only); the stats
    kernel with telemetry. Under the DCN pipeline (depth d) the apply and
    the stats kernel start at step d + 1, and lazy refresh launches no stats
    kernel (its disagreement is 0 there)."""
    cfg, n, world = trainer.cfg, trainer.n_params, trainer.world
    if not cfg.lion:
        return {"fused_ballots": 0, "fused_apply": 0, "bucket_vote_stats": 0}
    m_dtype, p_dtype = trainer.state.exp_avg.dtype, trainer.flat.params.dtype
    d = cfg.dcn_pipeline_depth   # the DCN pipeline: the first d steps apply no sign step
    if cfg.vote_every > 1:
        chunk = vote_chunk_elems(n, cfg.vote_every)
        voted = sum(sum(1 for start, _ in bucket_bounds(chunk, cfg.vote_buckets, world, cfg.wire)
                        if start < n - (t % cfg.vote_every) * chunk) for t in range(steps))
        f32 = m_dtype == torch.float32
        return {"fused_ballots": voted if f32 and cfg.max_grad_norm is None else 0,
                "fused_apply": max(steps - d, 0) if f32 and p_dtype == torch.float32 else 0,
                "bucket_vote_stats": voted if cfg.telemetry and not d else 0}
    buckets = len(bucket_bounds(n, cfg.vote_buckets, world, cfg.wire))
    det = cfg.max_grad_norm is None
    return {"fused_ballots": steps * buckets if det else 0,
            "fused_apply": max(steps - d, 0) * buckets if det else 0,
            "bucket_vote_stats": max(steps - d, 0) * buckets if cfg.telemetry else 0}


def flash_launches(steps: int, accum: int = ACCUM, eval_batches: int = EVAL_BATCHES,
                   layers: int = N_LAYER) -> dict:
    """The hd 64 flash kernels' launches of a GPT-2 run of ``layers`` blocks
    at dropout 0: forward twice per microbatch (remat) and once per eval
    batch."""
    return {"flash_attention_fwd": layers * (accum * 2 * steps + eval_batches),
            "flash_attention_bwd_dkv": layers * accum * steps,
            "flash_attention_bwd_dq": layers * accum * steps,
            "flash_attention_di": layers * accum * steps, **NO_HD128}


def lazy_checks(label: str, trainer, watch, steps: int) -> float:
    """A lazy run's :class:`StepWatch` record: every step's slice election
    equal to the plain election, the cold start, after a rotation the cache
    equal to a plain re-election of every slot, and the bytes the wire
    recorded each step equal to ``codec.wire_bytes_per_param``; returns the
    run's bits per param per step."""
    cfg = trainer.cfg
    want = wire_bytes_per_param(trainer.n_params, trainer.world, cfg.wire,
                                vote_every=cfg.vote_every,
                                vote_buckets=cfg.vote_buckets)["bytes_per_step"]
    cache_equal = steps < cfg.vote_every or torch.equal(watch.cache, trainer.state.elected)
    landed = steps - cfg.dcn_pipeline_depth
    if (watch.slices_equal != [True] * landed or not watch.cold_start or not cache_equal
            or watch.wire_bytes != [want] * steps):
        raise AssertionError(
            f"{label}: slice elections == plain {watch.slices_equal}, cold start (slots 1-"
            f"{cfg.vote_every - 1} decayed only, slot 0 moved) {watch.cold_start}, cache == plain "
            f"re-election {cache_equal}, wire bytes {watch.wire_bytes} (accounting {want})")
    return 8.0 * want / trainer.n_params


def expect(run: str, launches: dict, want: dict) -> None:
    for name, count in want.items():
        if launches[name] != count:
            raise AssertionError(f"run {run}: {name} launched {launches[name]} times, "
                                 f"expected {count} (all counts {launches})")


def flash_vs_xla_eval(trainer, model, eval_blocks, label: str) -> None:
    """The trained model's eval loss through flash (its run's ``attn_impl``,
    which takes flash at this shape) against its eval loss through
    ``attention_xla``, on the same weights and rows: within EVAL_TOL."""
    cfg = model.cfg
    flash_eval = trainer.evaluate(eval_blocks)["eval/loss"]
    model.cfg = dataclasses.replace(cfg, attn_impl="xla")
    xla_eval = trainer.evaluate(eval_blocks)["eval/loss"]
    model.cfg = cfg
    if not (math.isfinite(flash_eval) and math.isfinite(xla_eval)):
        raise AssertionError(f"{label}: eval losses {flash_eval}, {xla_eval}")
    print(f"[slice] {label}: eval loss through flash {flash_eval:.6f}, through attention_xla "
          f"{xla_eval:.6f} (bound {EVAL_TOL})", flush=True)
    if abs(flash_eval - xla_eval) > EVAL_TOL:
        raise AssertionError(f"{label}: eval loss through flash {flash_eval} vs xla {xla_eval}")


def nf4_check(gen) -> None:
    """``quantize_nf4`` and ``dequantize`` of one [4096, 11008] weight (a
    Llama-2-7B MLP projection) on the card equal to the CPU's, bit for bit;
    their times on the card."""
    w = torch.randn(4096, 11008, generator=gen, device="cuda") * 0.02
    card, host = quant.quantize_nf4(w), quant.quantize_nf4(w.cpu())
    torch.cuda.synchronize()
    if not (torch.equal(card.codes.cpu(), host.codes)
            and torch.equal(card.absmax.cpu(), host.absmax)):
        raise AssertionError("quantize_nf4 on the card differs from the CPU: "
                             f"{(card.codes.cpu() != host.codes).sum().item()} code bytes")
    for dt in (torch.bfloat16, torch.float32):
        got, want = quant.dequantize(card, dt).cpu(), quant.dequantize(host, dt)
        if not torch.equal(got.view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dt == torch.bfloat16 else torch.int32)):
            raise AssertionError(f"dequantize to {dt} on the card differs from the CPU")
    q_ms = time_ms(lambda: quant.quantize_nf4(w), runs=5)
    d_ms = time_ms(lambda: quant.dequantize(card, torch.bfloat16))
    print(f"[nf4] [4096, 11008] on the card == CPU (codes, absmax, dequantized bf16 and "
          f"float32); quantize {q_ms:.3f} ms, dequantize to bf16 {d_ms:.3f} ms (plain PyTorch)",
          flush=True)


SFT_ARGS = ["--model_name", "llama2_7b", "--quant", "nf4", "--attn_impl", "flash",
            "--seq_length", "1024", "--per_device_train_batch_size", "4",
            "--gradient_accumulation_steps", str(ACCUM), "--max_steps", str(STEPS),
            "--logging_steps", "1", "--lion", "--async_grad", "--wire", "auto"]
NO_HD128 = {f"{k}_hd128": 0 for k in FLASH}
NO_HD64 = dict.fromkeys(FLASH, 0)


def llama_run(gen):
    """Run (d): ``cli.run_sft.main`` on Llama-2-7B at full width and depth,
    NF4 base, LoRA q/v, flash at head_dim 128; returns (rows, launches,
    peak device bytes, wall s)."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, model, _ = run_sft.main(SFT_ARGS)
    wall = time.perf_counter() - t0
    launches, peak = read_counts(), torch.cuda.max_memory_allocated()
    rows = [r for r in trainer.history if "loss" in r]
    if len(rows) != STEPS or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"run (d): expected {STEPS} finite losses, got {rows}")
    cfg = trainer.cfg
    args, tok = run_sft.SFTArguments(), ByteTokenizer()
    train, valid = run_sft.sft_records(args)
    _, eval_rows = run_sft.sft_batches(args, tok, train, valid, trainer.global_train_batch(),
                                       cfg.seed, 1.0)
    per_dev = min(cfg.per_device_eval_batch_size, len(eval_rows))
    eval_batches = min(cfg.eval_iters, len(eval_rows) // per_dev)
    if trainer.n_params != N_SFT:
        raise AssertionError(f"run (d): {trainer.n_params} trainable coordinates, expected "
                             f"{N_SFT}")
    buckets = len(bucket_bounds(trainer.n_params, cfg.vote_buckets, trainer.world, cfg.wire))
    expect("(d)", launches, {
        "fused_ballots": STEPS * buckets, "fused_apply": STEPS * buckets, "bucket_vote_stats": 0,
        "flash_attention_fwd_hd128": LLAMA_LAYERS * (ACCUM * 2 * STEPS + eval_batches),
        "flash_attention_bwd_dkv_hd128": LLAMA_LAYERS * ACCUM * STEPS,
        "flash_attention_bwd_dq_hd128": LLAMA_LAYERS * ACCUM * STEPS,
        "flash_attention_di_hd128": LLAMA_LAYERS * ACCUM * STEPS, **NO_HD64})
    # the frozen base: the same codes, absmax and norm scales as a fresh init
    changed = changed_leaves(model.params, llama_init(model.cfg, seed=cfg.seed, device="cuda",
                                                   quant="nf4"))
    if changed:
        raise AssertionError(f"run (d): the frozen base changed in training: {changed[:8]}")
    print(f"[slice] (d): the frozen NF4 base is unchanged after training; {trainer.n_params} "
          f"trainable coordinates in {buckets} bucket(s); eval rows {len(eval_rows)}, "
          f"{eval_batches} eval batch(es)", flush=True)
    flash_vs_xla_eval(trainer, model, eval_rows, "Llama-2-7B (d)")
    profile_step(trainer, model, gen, 4, "Llama-2-7B (d)")
    del trainer, model
    torch.cuda.empty_cache()
    return rows, launches, peak, wall


DPO_PAIRS = 2   # run (j): pairs a microbatch, in training and in eval
DPO_ARGS = ["--model_name", "llama2_7b", "--attn_impl", "flash", "--quant_ref", "nf4",
            "--lion", "--async_grad", "--telemetry", "--wire", "auto",
            "--max_length", "1024", "--max_prompt_length", "512",
            "--per_device_train_batch_size", str(DPO_PAIRS),
            "--gradient_accumulation_steps", str(ACCUM), "--per_device_eval_batch_size",
            str(DPO_PAIRS), "--eval_iters", str(EVAL_BATCHES), "--max_steps", str(STEPS),
            "--logging_steps", "1"]
DPO_EVAL_KEYS = {"eval/loss", "eval/reward_accuracy", "eval/reward_margin"}


def changed_leaves(got_tree, want_tree) -> list:
    """The paths where two weight trees differ (dense leaves, or a quantized
    leaf's codes and absmax), or the paths only one of them has."""
    got, want = dict(iter_paths(got_tree)), dict(iter_paths(want_tree))
    if got.keys() != want.keys():
        return sorted("/".join(p) for p in got.keys() ^ want.keys())
    changed = []
    for path, g in got.items():
        w = want[path]
        if isinstance(g, quant.QuantizedTensor):
            same = (isinstance(w, quant.QuantizedTensor) and torch.equal(g.codes, w.codes)
                    and torch.equal(g.absmax, w.absmax))
        else:
            same = torch.equal(g, w)
        if not same:
            changed.append("/".join(path))
    return changed


K_STEPS, K_ACCUM, K_EVAL, K_T = 3, 2, 2, 2048   # run (k)
K_ARGS = ["--model_family", "llama", "--model_name", "llama3_8b", "--param_dtype", "bfloat16",
          "--compute_dtype", "bfloat16", "--dropout", "0", "--block_size", str(K_T),
          "--vocab_chunks", "8", "--per_device_train_batch_size", "1",
          "--gradient_accumulation_steps", str(K_ACCUM), "--max_steps", str(K_STEPS),
          "--logging_steps", "1", "--dataset", "synthetic", "--synthetic_blocks", "64",
          "--per_device_eval_batch_size", "1", "--eval_iters", str(K_EVAL), "--lion",
          "--async_grad", "--wire", "auto"]
XENT_CHUNKS = 8


def llama3_run(gen, rates):
    """Run (k): ``cli.run_clm.main`` trains every parameter of Llama-3-8B at
    full width and depth, bfloat16 params, 8 vocabulary chunks; returns
    (rows, launches, peak device bytes, wall s, optimizer step ms, its
    bound ms)."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = run_clm.main(K_ARGS)
    wall = time.perf_counter() - t0
    launches, peak = read_counts(), torch.cuda.max_memory_allocated()
    rows = [r for r in trainer.history if "loss" in r]
    if len(rows) != K_STEPS or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"run (k): expected {K_STEPS} finite losses, got {rows}")
    cfg, model = trainer.cfg, trainer.model
    if trainer.n_params != N_LLAMA3 or trainer.flat.params.dtype != torch.bfloat16:
        raise AssertionError(f"run (k): {trainer.n_params} {trainer.flat.params.dtype} params, "
                             f"expected {N_LLAMA3} bfloat16")
    if cfg.vocab_chunks != XENT_CHUNKS or model.cfg.attn_impl != "auto":
        raise AssertionError(f"run (k): vocab_chunks {cfg.vocab_chunks}, attn "
                             f"{model.cfg.attn_impl}")
    buckets = len(bucket_bounds(trainer.n_params, cfg.vote_buckets, trainer.world, cfg.wire))
    expect("(k)", launches, {
        "fused_ballots": K_STEPS * buckets, "fused_apply": K_STEPS * buckets,
        "bucket_vote_stats": 0,
        "flash_attention_fwd_hd128": LLAMA_LAYERS * (K_ACCUM * 2 * K_STEPS + K_EVAL),
        "flash_attention_bwd_dkv_hd128": LLAMA_LAYERS * K_ACCUM * K_STEPS,
        "flash_attention_bwd_dq_hd128": LLAMA_LAYERS * K_ACCUM * K_STEPS,
        "flash_attention_di_hd128": LLAMA_LAYERS * K_ACCUM * K_STEPS, **NO_HD64})
    print(f"[slice] (k): {trainer.n_params:,} bfloat16 params in {buckets} bucket(s), wire "
          f"{cfg.wire}; launches {launches}", flush=True)
    profile_step(trainer, model, gen, 1, "Llama-3-8B (k)", T=K_T)
    # one optimizer step over the 8.03B coordinates: ballots, the vote and
    # the apply; bound: g, m read and the int8 ballot written (5 B), then
    # p, g, m and the tally read and p, m written (11 B)
    opt_ms = time_ms(lambda: trainer.opt.step(trainer.flat, trainer.state))
    opt_bound, _ = bound(trainer.n_params * 16, 0, rates)
    print(f"[slice] (k) one optimizer step at n={trainer.n_params:,} (bfloat16 p, g, m): "
          f"{opt_ms:.4f} ms device time, bound {opt_bound:.4f} ms (16 B a coordinate)",
          flush=True)
    trainer.model = None
    del trainer, model
    torch.cuda.empty_cache()
    return rows, launches, peak, wall, opt_ms, opt_bound


def xent_check(gen) -> dict:
    """The ``[xent]`` check at run (k)'s head: the chunked cross entropy
    against the dense head + ``clm_loss_and_metrics``, forward and
    backward, each held to a float64 reference; peak memory above the
    inputs. Returns the printed numbers."""
    d, V, T = 4096, 128_256, K_T
    hidden0 = torch.randn(1, T, d, generator=gen, device="cuda").bfloat16()
    head0 = (torch.randn(d, V, generator=gen, device="cuda") * 0.02).bfloat16()
    h64, w64 = hidden0[0, :-1].double(), head0.double()
    logits64 = h64 @ w64
    # half the labels the float64 argmax, so `correct` counts something
    tokens = torch.randint(0, V, (1, T), generator=gen, device="cuda")
    tokens[0, 1::2] = logits64.argmax(-1)[0::2]
    labels = tokens[0, 1:]
    n = T - 1
    p = torch.softmax(logits64, -1)
    lse = torch.logsumexp(logits64, -1)
    loss64 = (lse - logits64.gather(1, labels[:, None])[:, 0]).mean().item()
    p[torch.arange(n, device="cuda"), labels] -= 1.0
    p /= n
    ref = {"hidden": p @ w64.t(), "lm_head": h64.t() @ p}
    del p, logits64, lse, h64, w64
    torch.cuda.empty_cache()

    def dense(h, w):
        return clm_loss_and_metrics(matmul_f32(h, w), tokens)

    def chunked(h, w):
        return chunked_clm_loss_and_metrics(h, w, tokens, XENT_CHUNKS, emb_layout="dv")

    out = {"loss_f64": loss64}
    grad_bytes = hidden0.numel() * 2 + head0.numel() * 2
    for name, fn in (("dense", dense), ("chunked", chunked)):
        h = hidden0.clone().requires_grad_()
        w = head0.clone().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, metrics = fn(h, w)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        grads = {"hidden": h.grad[0, :-1], "lm_head": w.grad}
        errs = {k: (grads[k].double() - ref[k]).abs().max().item() for k in ref}
        if h.grad[0, -1].abs().max().item() != 0.0:
            raise AssertionError(f"[xent] {name}: the last position took a gradient")

        def step():
            h.grad = w.grad = None
            fn(h, w)[0].backward()

        ms = time_ms(step, runs=5)
        out[name] = dict(loss=loss.item(), correct=round(metrics["accuracy"].item() * n),
                         peak=peak, work=peak - grad_bytes, ms=ms, **errs)
        print(f"[xent] {name}: N {n} d {d} V {V} bfloat16 'dv': loss {loss.item():.6f} "
              f"(float64 {loss64:.6f}), correct {out[name]['correct']}, max |d hidden - f64| "
              f"{errs['hidden']:.3e}, max |d lm_head - f64| {errs['lm_head']:.3e}; peak above "
              f"the inputs {peak / 1e9:.3f} GB, less the two gradients (d hidden, d lm_head "
              f"{grad_bytes / 1e9:.3f} GB) {(peak - grad_bytes) / 1e9:.3f} GB; forward + "
              f"backward {ms:.3f} ms", flush=True)
        del h, w, loss, metrics, grads
        torch.cuda.empty_cache()
    dn, ch = out["dense"], out["chunked"]
    if abs(ch["loss"] - dn["loss"]) > 1e-4 or ch["correct"] != dn["correct"]:
        raise AssertionError(f"[xent] chunked {ch} vs dense {dn}")
    for k in ref:
        slack = half_ulp_bf16(ref[k].abs().max().item())
        if ch[k] > 2 * dn[k] + slack:
            raise AssertionError(f"[xent] d {k}: chunked error {ch[k]} > 2 x dense {dn[k]} + "
                                 f"{slack}")
    if ch["work"] > dn["work"] / 4:
        raise AssertionError(f"[xent] chunked working memory {ch['work']} B > a quarter of the "
                             f"dense path's {dn['work']} B")
    print(f"[xent] chunked / dense: peak {ch['peak'] / dn['peak']:.3f}, working memory "
          f"{ch['work'] / dn['work']:.3f} (bound 0.25), time {ch['ms'] / dn['ms']:.3f}",
          flush=True)
    return out


def dpo_run(gen):
    """Run (j): ``cli.run_dpo.main`` on Llama-2-7B at full width and depth,
    a dense float32 policy base, an NF4 reference, LoRA over the DPO target
    set, flash at head_dim 128, telemetry; returns (rows, launches, peak
    device bytes, wall s, eval metrics)."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, model, adapters, ref = run_dpo.main(DPO_ARGS)
    wall = time.perf_counter() - t0
    launches, peak = read_counts(), torch.cuda.max_memory_allocated()
    rows = [r for r in trainer.history if "loss" in r]
    if len(rows) != STEPS or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"run (j): expected {STEPS} finite losses, got {rows}")
    cfg = trainer.cfg
    if trainer.n_params != N_DPO:
        raise AssertionError(f"run (j): {trainer.n_params} trainable coordinates, expected "
                             f"{N_DPO}")
    buckets = len(bucket_bounds(trainer.n_params, cfg.vote_buckets, trainer.world, cfg.wire))
    # per microbatch: two policy passes, each forward twice (remat), and two
    # reference passes under no_grad; four passes per eval batch
    expect("(j)", launches, {
        "fused_ballots": STEPS * buckets, "fused_apply": STEPS * buckets,
        "bucket_vote_stats": STEPS * buckets,
        "flash_attention_fwd_hd128": LLAMA_LAYERS * (6 * ACCUM * STEPS + 4 * EVAL_BATCHES),
        "flash_attention_bwd_dkv_hd128": LLAMA_LAYERS * 2 * ACCUM * STEPS,
        "flash_attention_bwd_dq_hd128": LLAMA_LAYERS * 2 * ACCUM * STEPS,
        "flash_attention_di_hd128": LLAMA_LAYERS * 2 * ACCUM * STEPS, **NO_HD64})
    args = run_dpo.DPOArguments(max_length=1024, max_prompt_length=512)
    data = prepare_dpo_batch(run_dpo.dpo_records(args), ByteTokenizer(), max_length=1024,
                             max_prompt_length=512)
    n_valid = min(args.size_valid_set, len(data["chosen"]) // 4)   # run_dpo's eval split
    eval_rows = {k: v[:n_valid] for k, v in data.items()}
    ev = trainer.evaluate(eval_rows)
    if set(ev) != DPO_EVAL_KEYS or not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"run (j): eval metrics {ev}, expected finite {DPO_EVAL_KEYS}")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:DPO_PAIRS])).cuda()
             for k, v in eval_rows.items()}
    profile_step(trainer, model, gen, DPO_PAIRS, "Llama-2-7B DPO (j)", rows=batch)
    del trainer, adapters
    torch.cuda.empty_cache()
    # the dense base and the NF4 reference, unchanged: a fresh init from the
    # same seed, and its quantization
    fresh = llama_init(model.cfg, seed=cfg.seed, device="cuda")
    changed = changed_leaves(model.params, fresh)
    fresh_ref = quant.quantize_tree(fresh, "nf4")
    changed += changed_leaves(ref, fresh_ref)
    if changed:
        raise AssertionError(f"run (j): the frozen base or reference changed: {changed[:8]}")
    n_quant = sum(isinstance(w, quant.QuantizedTensor) for _, w in iter_paths(ref))
    del fresh, fresh_ref
    torch.cuda.empty_cache()
    # exact: fresh adapters (B = 0) against the dense base as reference
    lcfg = LoraConfig(r=8, alpha=16, dropout=0.05, target_patterns=DPO_TARGET_PATTERNS)
    zero_b = lora_init(model.params, lcfg, seed=cfg.seed + 1)
    loss_fn = run_dpo.dpo_loss_fn(model, model.params, model.params, zero_b, lcfg, 0.1)
    with torch.no_grad():
        loss, m = loss_fn(batch, None)
    want = -F.logsigmoid(torch.zeros((), device="cuda"))
    if not (torch.equal(loss, want) and float(m["reward_margin"]) == 0.0):
        raise AssertionError(f"run (j): at B = 0 against the dense base, loss {loss.item()!r} "
                             f"(want {want.item()!r}), reward_margin {m['reward_margin'].item()}")
    print(f"[slice] (j): {N_DPO:,} trainable coordinates in {buckets} bucket(s); "
          f"the dense base and the NF4 reference ({n_quant} quantized leaves) unchanged after "
          f"training; eval {ev}; at B = 0 against the dense base the loss is -logsigmoid(0) = "
          f"{loss.item()!r} bit for bit and reward_margin 0", flush=True)
    del model, ref, zero_b, batch, loss, m
    torch.cuda.empty_cache()
    return rows, launches, peak, wall, ev


def stochastic_check(gen) -> None:
    """Run (e)'s stochastic ballots at the main path's size, on seeded g and
    m whose update direction u spreads past ±r: where ``|u| >= r`` equal to
    the deterministic ballots; the same bits from the same (seed, count,
    rank); other bits from another rank; and the mean of ``ballot - (2p -
    1)`` over all coordinates within STOCH_SIGMAS standard deviations of 0
    (sigma^2 = sum 4p(1 - p) / n^2)."""
    n = N_MAIN
    g = torch.randn(n, generator=gen, device="cuda") * 2.5
    m = torch.randn(n, generator=gen, device="cuda") * 2.5
    r = (1.0 + 1.0 / B1) * STOCH_MGN

    def draw(rank):
        return lion_math.stochastic_vote_bool(
            g, m, B1, STOCH_MGN, lion_math.stochastic_generator(STOCH_SEED, 0, rank, g.device))

    ballots = draw(0)
    sat = lion_math.interp(g, m, B1).abs() >= r
    det = lion_math.sign_vote_bool(g, m, B1)
    same_saturated = torch.equal(ballots[sat], det[sat])
    replayed = torch.equal(ballots, draw(0))
    other_rank = int((ballots != draw(1)).sum())
    p = lion_math.stochastic_p_up(g, m, B1, STOCH_MGN).double()
    drift = ((2.0 * ballots.double() - 1.0) - (2.0 * p - 1.0)).mean().item()
    sigma = math.sqrt((4.0 * p * (1.0 - p)).sum().item()) / n
    n_sat = int(sat.sum())
    print(f"[stochastic] n={n}, r={r:.4f}: {n_sat} saturated coordinates (|u| >= r) "
          f"{'==' if same_saturated else '!='} the deterministic ballots; the same "
          f"(seed, count, rank) {'gives the same bits' if replayed else 'DIFFERS'}; rank 1 "
          f"differs in {other_rank} coordinates; mean(ballot - (2p - 1)) = {drift:.3e}, "
          f"bound {STOCH_SIGMAS} sigma = {STOCH_SIGMAS * sigma:.3e}", flush=True)
    if not (same_saturated and replayed and other_rank > 0 and 0 < n_sat < n
            and abs(drift) <= STOCH_SIGMAS * sigma):
        raise AssertionError("run (e): the stochastic ballots fail a check (line above)")


# run (n), the NaN sentinel at W = 1: step 3's grads NaN (count 2); the check
# of step 3 runs after step 4 is issued, arms a 1-step trace window, and the
# run raises after step 6
N_POISON, N_TRIP, N_STEPS = "nan_grads:0:2", 3, 8
N_ARGS = ["--dropout", "0", "--nan_sentinel", "--trace_on_anomaly", "--profile_start_step", "1",
          "--profile_num_steps", "1", "--inject_poison", N_POISON, "--journal"]
TRITON_NAMES = ("_ballot_kernel", "_apply_kernel")   # the Triton kernels, as traces name them


def sentinel_run(tmp: str, card: str) -> dict:
    """Run (n): ``run_clm.main`` at (c)'s setup with the sentinel, a trace
    window at step 1, ``--trace_on_anomaly`` and rank 0's grads NaN from
    count 2. It must raise exactly ``FloatingPointError("non-finite
    grad_norm=nan at step 3")``; the bundle lists every momentum
    coordinate's leaf (all NaN) and no param (a NaN ballot votes -1: the
    params move by a finite step); the ``--profile_dir`` trace and the
    anomaly trace under the bundle exist and name the Triton kernels; the
    launches are 6 steps' (the run stops before its eval). With
    ``--journal`` the bundle holds ``journal_tail.jsonl``, strict JSON,
    whose last record is the trip's ``[trainer] ANOMALY`` message. Returns
    the launches."""
    t = time.perf_counter()
    prof, out = f"{tmp}/n_prof", f"{tmp}/n_out"
    reset_counts()
    try:
        run_clm.main(SLICE_ARGS + N_ARGS + ["--profile_dir", prof, "--output_dir", out,
                                            "--max_steps", str(N_STEPS)])
    except FloatingPointError as e:
        reason = str(e)
    else:
        raise AssertionError("run (n): the sentinel did not raise FloatingPointError")
    launches = read_counts()
    want = f"non-finite grad_norm=nan at step {N_TRIP}"
    if reason != want:
        raise AssertionError(f"run (n): FloatingPointError({reason!r}), expected {want!r}")
    steps = N_TRIP + 3   # the check after step 4, one traced step, then one more
    expect("(n) nan_sentinel + trace_on_anomaly", launches,
           dict(fused_ballots=steps, fused_apply=steps, bucket_vote_stats=0,
                **flash_launches(steps, eval_batches=0)))
    crash = pathlib.Path(out) / "crash" / f"step_{N_TRIP:08d}"
    text = (crash / "bundle.json").read_text()
    bundle = json.loads(text)
    opt = bundle["nonfinite_opt_state"]
    traces = {"profile_dir": sorted(pathlib.Path(prof).glob("*.json")),
              "anomaly": sorted((crash / "trace").glob("*.json"))}
    named = {k: [all(n in p.read_text() for n in TRITON_NAMES) for p in v]
             for k, v in traces.items()}
    if (bundle["step"] != N_TRIP or bundle["reason"] != want or bundle["nonfinite_params"]
            or sum(opt.values()) != N_MAIN or not all(k.startswith(".exp_avg[") for k in opt)
            or "NaN" in text or named != {"profile_dir": [True], "anomaly": [True]}):
        raise AssertionError(f"run (n): bundle step {bundle['step']}, reason "
                             f"{bundle['reason']!r}, nonfinite params "
                             f"{bundle['nonfinite_params']}, {len(opt)} momentum leaves with "
                             f"{sum(opt.values())} nonfinite coordinates; traces {traces} naming "
                             f"{TRITON_NAMES}: {named}")
    tail = [strict_json(line) for line in (crash / "journal_tail.jsonl").read_text().splitlines()]
    if (not tail or not all({"kind", "name", "t", "rank"} <= set(r) for r in tail)
            or tail[-1]["kind"] != "log" or not tail[-1]["msg"].startswith("[trainer] ANOMALY: "
                                                                            + want)):
        raise AssertionError(f"run (n): the bundle's journal_tail.jsonl ends in "
                             f"{tail[-3:] if tail else tail}, not the trip")
    sizes = {k: [p.stat().st_size for p in v] for k, v in traces.items()}
    print(f"[sentinel] (n) GPT-2 124M, 1 rank, {N_POISON}, --journal: FloatingPointError("
          f"{reason!r}) after step {steps}; bundle {crash.relative_to(out)}/bundle.json names "
          f"{len(opt)} momentum leaves ({sum(opt.values())} coordinates) and no param; "
          f"journal_tail.jsonl {len(tail)} records ({sorted({r['kind'] for r in tail})}), the last "
          f"{tail[-1]['msg']!r}; traces (bytes) {sizes}, both naming {TRITON_NAMES}; launches "
          f"{launches}; {time.perf_counter() - t:.1f} s on {card}", flush=True)
    shutil.rmtree(out)
    shutil.rmtree(prof)
    return launches


def mode_step_times(gen) -> dict:
    """Device time of one optimizer step at the main path's size in a world
    of one (no collective), on the same grads: the fused deterministic step
    (float32), the stochastic one, lazy refresh at K 4 with every slot
    voted and at its first step, lazy refresh under stochastic binarization
    with every slot voted, the fused step at bfloat16 momentum under
    float32 params, and AdamW; returns them by label (ms)."""
    times = {}
    g = torch.randn(N_MAIN, generator=gen, device="cuda")
    cases = (("fused", lambda: DistributedLion(3e-4, weight_decay=0.1), 0),
             ("stochastic", lambda: DistributedLion(3e-4, weight_decay=0.1,
                                                    max_grad_norm=STOCH_MGN, seed=STOCH_SEED), 0),
             (f"lazy K {LAZY_K}, all slots voted",
              lambda: DistributedLion(3e-4, weight_decay=0.1, vote_every=LAZY_K), LAZY_K - 1),
             (f"lazy K {LAZY_K}, first step",
              lambda: DistributedLion(3e-4, weight_decay=0.1, vote_every=LAZY_K), 0),
             (f"lazy stochastic K {LAZY_K}, all slots voted",
              lambda: DistributedLion(3e-4, weight_decay=0.1, vote_every=LAZY_K,
                                      max_grad_norm=STOCH_MGN, seed=STOCH_SEED), LAZY_K - 1),
             ("fused, bf16 momentum",
              lambda: DistributedLion(3e-4, weight_decay=0.1, mom_dtype="bfloat16"), 0),
             ("guard enforce", lambda: DistributedLion(3e-4, weight_decay=0.1,
                                                       guard="enforce"), 0),
             ("guard observe", lambda: DistributedLion(3e-4, weight_decay=0.1,
                                                       guard="observe"), 0),
             ("AdamW", lambda: adamw(3e-4), 0))
    for label, make, count in cases:
        flat = FlatParams([("p", torch.nn.Parameter(
            torch.randn(N_MAIN, generator=gen, device="cuda")))])
        flat.grads.copy_(g)
        opt = make()
        state = opt.init(flat)
        if count:
            state = state._replace(count=torch.full((), count, dtype=torch.int32, device="cuda"),
                                   steps=count)
        times[label] = time_ms(lambda: opt.step(flat, state))
        state_bytes = sum(t.numel() * t.element_size() for t in state
                          if isinstance(t, torch.Tensor) and t.dim())
        added = ""
        if label.startswith("guard"):
            # a pass over g and m (the nonfinite count), the sanitize's write
            # of g under enforce, the packed ballot written and XORed with the
            # previous one
            nbytes = (8 + (4 if "enforce" in label else 0)) * N_MAIN + 3 * N_MAIN // 8
            ms = nbytes / card_rates(torch.cuda.get_device_name(0))[0] * 1e3
            added = f"; added bytes {nbytes} ({ms:.4f} ms at the data-sheet bandwidth)"
        print(f"[modes] optimizer step at n={N_MAIN}, one bucket, no collective, {label}: "
              f"{times[label]:.4f} ms; optimizer state {state_bytes} bytes a rank{added}",
              flush=True)
        if label == "fused" or label.startswith("guard"):
            # where the guard's time goes: one profiled step, kernel by kernel
            _, device = device_events(lambda: opt.step(flat, state))
            ranked = kernel_table(device)
            print(f"[modes] {label}, one profiled step: {len(device)} device kernels, "
                  f"{sum(t for _, (t, _) in ranked) / 1e3:.4f} ms of kernel time; "
                  + "; ".join(f"{t / 1e3:.4f} ms {c}x {name[:90]}"
                              for name, (t, c) in ranked[:GUARD_TOP]), flush=True)
        del flat, opt, state
        torch.cuda.empty_cache()
    return times


def plain_election(gathered, wire: str, alive=None):
    """The election of ``wire`` from every rank's int8 ballots, in plain
    PyTorch: a strict majority (ties -1), or for ``hier:<g>`` a strict
    majority of the groups' strict majorities; and the flat tally. With
    ``alive`` (the guard's health mask) only the healthy ranks' ballots
    count, and a group with none abstains."""
    live = [True] * len(gathered) if alive is None else [bool(a) for a in alive.tolist()]

    def tally_of(ranks):
        return sum(gathered[r].to(torch.int32) for r in ranks if live[r])

    tally = tally_of(range(len(gathered)))
    kind, size = parse_wire(wire)
    if kind != "hier":
        return tally > 0, tally
    groups = [range(k * size, (k + 1) * size) for k in range(len(gathered) // size)]
    voting = [g for g in groups if any(live[r] for r in g)]
    verdicts = sum((tally_of(g) > 0).to(torch.int32) for g in voting)
    return verdicts * 2 > len(voting), tally


class StepWatch:
    """Checks, in every rank, around ``DistributedLion.step`` while
    installed: after every step all ranks' flat params must be
    ``torch.equal`` (rank 0's broadcast; nothing to compare in a world of
    one); at the first step of a deterministic wire, and under ``--vote_guard
    enforce`` at every step (the ballots of the grads with their nonfinite
    coordinates zeroed, the election masked by the step's health mask), the
    election (the telemetry frame's) must equal :func:`plain_election` of
    the gathered ballots and, on a tally wire at W4, the frame's margin
    histogram and disagreement must equal ``bucket_vote_stats_plain`` of
    the gathered (masked) tally; ``masked`` records, step by step, whether
    the mask held a quarantined rank, and ``voters`` its healthy count. Under ``vote_every`` K > 1, at every step: the slot's slice of
    the refreshed cache must equal the plain election of the gathered
    slice ballots (under ``max_grad_norm`` the ballots replayed from
    (seed, count, rank), ``replay_slice_ballots``; ``slices_equal``;
    ``cache`` accumulates those plain
    elections, so after K steps it is a plain re-election of every slot);
    the bytes the wire records per step (``wire_bytes``); and at the first
    step, the coordinates outside slot 0 must equal their decayed values
    (no sign step) and those of slot 0 must all have moved. Under the DCN
    pipeline (``dcn_pipeline_depth`` d > 0) the gathered ballots (or slice
    ballots) of each step wait d steps: a step that consumes them must apply
    the plain election of them (the health mask unchanged in flight), and
    its stats kernel's disagreement (fresh ballots against that stale
    election) must equal ``bucket_vote_stats_plain``'s; every-step, the
    first d steps' params must equal the plain decay of the previous ones
    (``cold_equal``); lazy, at every step the slots not landed yet must
    equal their decayed values and the landed ones must all have moved."""

    def __init__(self):
        self.pending: list = []   # the DCN pipeline's launches in flight
        self.cold_equal: list = []
        self.params_equal: list = []
        self.election_equal: list = []
        self.hist: list = []
        self.masked: list = []
        self.voters: list = []
        self.slices_equal: list = []
        self.wire_bytes: list = []
        self.cold_start = None
        self.cache = None
        self.tally = collectives.WireTally()
        self._orig = DistributedLion.step
        watch = self

        def step(opt, flat, state):
            return watch._observe(opt, flat, state)

        DistributedLion.step = step

    def close(self) -> None:
        DistributedLion.step = self._orig

    def _gather(self, opt, ballots):
        if opt.world == 1:
            return [ballots]
        gathered = [torch.empty_like(ballots) for _ in range(opt.world)]
        dist.all_gather(gathered, ballots, group=opt.group)
        return gathered

    def _observe(self, opt, flat, state):
        lazy = opt.vote_every > 1
        guarded = opt.guard == "enforce"
        check = (state.steps == 0 or guarded) and opt.max_grad_norm is None
        if lazy:
            return self._observe_lazy(opt, flat, state)
        if opt.depth > 0:
            return self._observe_pipelined(opt, flat, state)
        ballots = alive = None
        if check:
            g = flat.grads.to(state.exp_avg.dtype)
            if guarded:
                g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                alive = state.health.clone()
            ballots = fused_lion.fused_ballots_plain(g, state.exp_avg, opt.b1)
            del g
        out = self._orig(opt, flat, state)
        frame = out[1]
        self._params_equal(opt, flat)
        if check:
            gathered = self._gather(opt, ballots)
            want, tally = plain_election(gathered, opt.wire, alive)
            self.election_equal.append(
                torch.equal(unpack_signs(frame["elected"], (flat.numel,)), want))
            self.masked.append(alive is not None and not bool(alive.all()))
            if alive is not None:
                self.voters.append(int(alive.sum()))
            if collectives.world_of(opt.group) == W4 and opt.wire == "sign_psum":
                hist, dis = fused_lion.bucket_vote_stats_plain(ballots, tally, opt.world, 8)
                self.hist.append((frame["margin_hist"].tolist(), hist.tolist(),
                                  int(frame["disagree"]), int(dis)))
            del gathered, want, tally
        return out

    def _observe_pipelined(self, opt, flat, state):
        g = flat.grads.to(state.exp_avg.dtype)
        alive = None
        if opt.guard == "enforce":
            g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
            alive = state.health.clone()
        ballots = fused_lion.fused_ballots_plain(g, state.exp_avg, opt.b1)
        del g
        p_before = flat.params.clone()
        lr = resolve_lr(opt.learning_rate, state.count)
        out = self._orig(opt, flat, state)
        frame = out[1]
        self._params_equal(opt, flat)
        self.pending.append((self._gather(opt, ballots), alive))
        if state.steps < opt.depth:   # nothing has landed: decay only
            decayed = lion_math.decay_params(p_before, lr, opt.weight_decay)
            self.cold_equal.append(torch.equal(flat.params, decayed))
            del decayed
        else:
            launched, alive_then = self.pending.pop(0)
            if (alive is None) != (alive_then is None) or (
                    alive is not None and not torch.equal(alive, alive_then)):
                raise AssertionError("StepWatch checks a pipeline whose mask does not change "
                                     "in flight")
            want, _ = plain_election(launched, opt.wire, alive)
            self.election_equal.append(
                torch.equal(unpack_signs(frame["elected"], (flat.numel,)), want))
            _, dis = fused_lion.bucket_vote_stats_plain(
                ballots, torch.where(want, 1, -1).to(torch.int8), opt.world, 8)
            self.hist.append(([], [], int(frame["disagree"]), int(dis)))
            del launched, want
        del p_before
        return out

    def _params_equal(self, opt, flat) -> None:
        if opt.world == 1:
            self.params_equal.append(True)
            return
        ref = flat.params.clone()
        dist.broadcast(ref, 0, group=opt.group)
        differ = torch.tensor([0 if torch.equal(ref, flat.params) else 1])
        dist.all_reduce(differ, group=opt.group)
        self.params_equal.append(int(differ) == 0)

    def _observe_lazy(self, opt, flat, state):
        if state.exp_avg.dtype != torch.float32:
            raise AssertionError("StepWatch re-elects float32-momentum lazy steps only")
        n, k = flat.numel, opt.vote_every
        chunk = vote_chunk_elems(n, k)
        lo = (state.steps % k) * chunk
        real = max(0, min(chunk, n - lo))
        ballots = torch.full((chunk,), -1, dtype=torch.int8, device=flat.device)
        if opt.max_grad_norm is None:
            ballots[:real] = fused_lion.fused_ballots_plain(flat.grads[lo:lo + real],
                                                            state.exp_avg[lo:lo + real], opt.b1)
        else:   # the stochastic ballots, replayed from (seed, count, rank)
            ballots[:real] = torch.where(opt.replay_slice_ballots(
                flat.grads, state.exp_avg, state.steps), 1, -1).to(torch.int8)
        first = state.steps == 0
        d = opt.depth
        if first:
            self.cache = torch.zeros_like(state.elected)
            self.cold_start = True
        if first or d:
            p_before = flat.params.clone()
            lr = resolve_lr(opt.learning_rate, state.count)
        opt.tally = self.tally
        before = self.tally.total()
        new_state, frame = self._orig(opt, flat, state)
        self.wire_bytes.append(self.tally.total() - before)
        self._params_equal(opt, flat)
        want, _ = plain_election(self._gather(opt, ballots), opt.wire)
        self.pending.append((lo, want))
        if state.steps >= d:   # the election of the slice launched d steps ago lands
            wlo, want = self.pending.pop(0)
            got = new_state.elected[wlo // 8:(wlo + chunk) // 8]
            self.slices_equal.append(torch.equal(unpack_signs(got, (chunk,)), want))
            self.cache[wlo // 8:(wlo + chunk) // 8] = pack_signs(want)
        if first or d:   # slots 0..count - d have landed and move; the rest decay only
            valid = min(max(state.steps - d + 1, 0) * chunk, n)
            decayed = lion_math.decay_params(p_before, lr, opt.weight_decay)
            self.cold_start = (self.cold_start
                               and torch.equal(flat.params[valid:], decayed[valid:])
                               and bool((flat.params[:valid] != decayed[:valid]).all()))
            del p_before, decayed
        return new_state, frame


def strict_json(line: str):
    """One JSONL record, refusing the non-JSON NaN and Infinity tokens."""
    def refuse(token):
        raise ValueError(f"non-JSON token {token}")
    return json.loads(line, parse_constant=refuse)


def params_sha(trainer) -> str:
    return hashlib.sha256(trainer.flat.params.cpu().numpy().tobytes()).hexdigest()


class BoundaryWatch:
    """Records ``[kind, step, lifecycle, mask]`` of the trainer's control
    plane after each of its ``_apply_membership`` and ``_apply_guard``
    calls while installed."""

    def __init__(self):
        self.rows: list = []
        self._orig = {k: getattr(train_loop.Trainer, k)
                      for k in ("_apply_membership", "_apply_guard")}
        watch = self

        def wrap(kind, fn):
            def call(trainer, step, *args):
                fn(trainer, step, *args)
                plane = trainer._cplane
                watch.rows.append([kind, int(step), plane.lifecycle(),
                                   [bool(b) for b in plane.alive_mask()]])
            return call

        for k, fn in self._orig.items():
            setattr(train_loop.Trainer, k, wrap(k, fn))

    def close(self) -> None:
        for k, fn in self._orig.items():
            setattr(train_loop.Trainer, k, fn)


class HealWatch:
    """Wraps the trainer's ``heal_rank_momentum`` while installed: before a
    heal every rank's momentum is gathered and their healthy mean formed in
    plain float32, summed in rank order; after it each healed rank records
    whether its momentum is ``torch.equal`` to that mean, and every rank the
    heal's own seconds (the check's gather not counted)."""

    def __init__(self):
        self.equal: list = []
        self.seconds: list = []
        self._orig = train_loop.heal_rank_momentum
        watch = self

        def heal(m, healthy, workers, group):
            rows = [torch.empty_like(m) for _ in range(W4)]
            dist.all_gather(rows, m.contiguous(), group=group)
            src = [r for r in range(W4) if healthy[r]]
            total = rows[src[0]].clone()
            for r in src[1:]:
                total = total + rows[r]
            # a true division, as the heal's (a CUDA tensor over a host
            # float multiplies by its reciprocal, an ulp away)
            want = total / torch.tensor(float(len(src)), device=m.device)
            del rows, total
            t0 = time.perf_counter()
            watch._orig(m, healthy, workers, group)
            watch.seconds.append(time.perf_counter() - t0)
            if dist.get_rank(group) in [int(w) for w in workers]:
                watch.equal.append(bool(torch.equal(m, want)))

        train_loop.heal_rank_momentum = heal

    def close(self) -> None:
        train_loop.heal_rank_momentum = self._orig


def q_run(rank: int) -> dict:
    """Run (q) on one rank of the W4 spawn. (q1) ``Q1_ARGS``, Q1_STEPS steps,
    under a :class:`StepWatch`: steps 1-2 ``torch.equal`` to a plain decay
    of the previous params, from step 3 the applied election equal to the
    plain ``hier:2`` election of the ballots of step t - 2 and the stats
    kernel's disagreement to ``bucket_vote_stats_plain``'s; params equal on
    every rank; the ring ``[2, hier_ring_slot_bytes]`` uint8;
    ``comm_drift_bytes`` 0 and ``dcn_overlap_frac`` 1 in every row; no guard
    transition. (q2) ``Q2_ARGS``, Q2_STEPS steps: slot j moves first at
    step j + 2 and the cache after the run is a plain re-election of every
    landed slot (``lazy_checks``). (q3) the ``dcn_delay`` link at Q3_DELAY
    s, armed before each trainer is built: (q1)'s setup at depth 2 and at
    0 (``Q3_RUNS``); their ``dcn_wait_s`` sums, depth 2's below depth 0's
    and depth 0's at least 2 x the delay."""
    watch, events = StepWatch(), GuardEvents()
    reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run_clm.main(W4_ARGS + Q1_ARGS + ["--max_steps", str(Q1_STEPS)])
    finally:
        watch.close()
        events.close()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect(f"(q1) rank {rank}", launches, dict(optimizer_launches(trainer, Q1_STEPS),
                                               **flash_launches(Q1_STEPS, accum=1, eval_batches=0,
                                                                layers=W4_LAYERS)))
    rows = [r for r in trainer.history if "loss" in r]
    cfg, ring = trainer.cfg, trainer.state.dcn_ring
    d = cfg.dcn_pipeline_depth
    slot = hier_ring_slot_bytes(N_W4, W4, 2, cfg.vote_buckets)
    q1 = {"run": "q1", "losses": [r["loss"] for r in rows], "step_ms": [r["step_ms"] for r in rows],
          "params_equal": watch.params_equal, "cold_equal": watch.cold_equal,
          "election_equal": watch.election_equal, "dis": [h[2:] for h in watch.hist],
          "ring": [list(ring.shape), str(ring.dtype)], "slot": slot,
          "buckets": cfg.vote_buckets, "drift": [r.get("comm_drift_bytes") for r in rows],
          "overlap": [r.get("dcn_overlap_frac") for r in rows], "launches": launches,
          "wall_s": wall, "events": events.events}
    if not (len(rows) == Q1_STEPS and all(math.isfinite(x) for x in q1["losses"])
            and watch.params_equal == [True] * Q1_STEPS and watch.cold_equal == [True] * d
            and watch.election_equal == [True] * (Q1_STEPS - d)
            and all(a == b for a, b in q1["dis"]) and len(q1["dis"]) == Q1_STEPS - d
            and q1["ring"] == [[d, slot], "torch.uint8"] and trainer.state.exp_avg.numel() == N_W4
            and hier_ring_slot_bytes(N_W4, W4, 2, 1) == Q1_SLOT_ONE_BUCKET
            and q1["drift"] == [0] * Q1_STEPS and q1["overlap"] == [1.0] * Q1_STEPS
            and not events.events and all(trainer.state.health.tolist())):
        raise AssertionError(f"run (q1) rank {rank}: {q1}")
    del trainer, ring
    torch.cuda.empty_cache()
    watch = StepWatch()
    reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run_clm.main(W4_ARGS + Q2_ARGS + ["--max_steps", str(Q2_STEPS)])
    finally:
        watch.close()
    wall2 = time.perf_counter() - t0
    launches2 = read_counts()
    expect(f"(q2) rank {rank}", launches2, dict(optimizer_launches(trainer, Q2_STEPS),
                                                **flash_launches(Q2_STEPS, accum=1, eval_batches=0,
                                                                 layers=W4_LAYERS)))
    bits = lazy_checks(f"run (q2) rank {rank}", trainer, watch, Q2_STEPS)
    rows = [r for r in trainer.history if "loss" in r]
    q2 = {"losses": [r["loss"] for r in rows], "step_ms": [r["step_ms"] for r in rows],
          "valid_frac": [r["vote/valid_frac"] for r in rows], "bits": bits,
          "slices_equal": watch.slices_equal, "launches": launches2, "wall_s": wall2,
          "params_equal": watch.params_equal}
    if watch.params_equal != [True] * Q2_STEPS or not all(map(math.isfinite, q2["losses"])):
        raise AssertionError(f"run (q2) rank {rank}: {q2}")
    del trainer
    torch.cuda.empty_cache()
    q3 = {}
    for depth, steps in Q3_RUNS:
        resilience.inject_fault("dcn_delay", Q3_DELAY)
        collectives.dcn_link_reset()
        t0 = time.perf_counter()
        try:
            trainer = run_clm.main(W4_ARGS + Q1_ARGS[:2] + [
                "--dcn_pipeline_depth", str(depth), "--vote_guard", "enforce",
                "--max_steps", str(steps)])
        finally:
            resilience.inject_fault("dcn_delay", None)
            collectives.dcn_link_reset()
        rows = [r for r in trainer.history if "loss" in r]
        q3[depth] = {"waits": [r.get("dcn_wait_s", 0.0) for r in rows],
                     "step_ms": [r["step_ms"] for r in rows],
                     "wall_s": time.perf_counter() - t0}
        del trainer
        torch.cuda.empty_cache()
    hidden, sync = sum(q3[2]["waits"]), sum(q3[0]["waits"])
    if not (hidden < sync and sync >= 2 * Q3_DELAY):
        raise AssertionError(f"run (q3) rank {rank}: dcn_wait_s at depth 2 {q3[2]}, at depth 0 "
                             f"{q3[0]}")
    return {"run": "dcn pipeline", "q1": q1, "q2": q2, "q3": q3}


def q_report(rec: dict, card: str) -> None:
    """Run (q)'s lines, rank 0's record."""
    q1, q2, q3 = rec["q1"], rec["q2"], rec["q3"]
    print(f"[w4] (q1) hier:2 --dcn_pipeline_depth 2 --vote_guard enforce --telemetry: {W4_GPT2}, "
          f"{W4} ranks on one card (gloo), B 2 x accum 1 x T 1024, {q1['buckets']} bucket(s), "
          f"{Q1_STEPS} steps: losses {[round(x, 4) for x in q1['losses']]}; steps 1-2 == a plain "
          f"decay {q1['cold_equal']}; from step 3 the applied election == plain hier:2 election "
          f"of the 4 ranks' ballots of step t - 2 {q1['election_equal']}, stats-kernel "
          f"disagreement == bucket_vote_stats_plain (fresh ballots against the stale election) "
          f"{q1['dis']}; params equal on all ranks after each step {q1['params_equal']}; ring "
          f"{q1['ring']} ({q1['slot']:,} bytes a slot; {Q1_SLOT_ONE_BUCKET:,} at one bucket), "
          f"{q1['ring'][0][0] * q1['slot']:,} bytes a rank; comm_drift_bytes {q1['drift']}, "
          f"dcn_overlap_frac {q1['overlap']}; guard transitions {q1['events']}; step ms "
          f"{q1['step_ms']}; run_clm.main {q1['wall_s']:.1f} s on {card}; rank 0 launches "
          f"{q1['launches']}", flush=True)
    print(f"[w4] (q2) hier:2 --vote_every {LAZY_K} --dcn_pipeline_depth 1, {Q2_STEPS} steps: "
          f"losses {[round(x, 4) for x in q2['losses']]}; each landed slot's election == the "
          f"plain election of its slice ballots one step before {q2['slices_equal']}; slot j "
          f"moves first at step j + 2 (the others equal their decay); the cache after step "
          f"{Q2_STEPS} == a plain re-election of every landed slot; vote/valid_frac "
          f"{q2['valid_frac']}; {q2['bits']:.4f} bits/param/step; step ms {q2['step_ms']}; "
          f"run_clm.main {q2['wall_s']:.1f} s on {card}; rank 0 launches {q2['launches']}",
          flush=True)
    print(f"[w4] (q3) the dcn_delay link at {Q3_DELAY} s, (q1)'s setup: dcn_wait_s at depth 2 "
          f"({Q3_RUNS[0][1]} steps) {q3['2']['waits']} = {sum(q3['2']['waits']):.4f} s; at depth "
          f"0 ({Q3_RUNS[1][1]} steps) {q3['0']['waits']} = {sum(q3['0']['waits']):.4f} s; step ms "
          f"{q3['2']['step_ms']} / {q3['0']['step_ms']}; run_clm.main {q3['2']['wall_s']:.1f} / "
          f"{q3['0']['wall_s']:.1f} s on {card}", flush=True)


class ZeroWatch:
    """Checks, in every rank, around ``AdamWZero1.step`` while installed:
    after every step all ranks' flat params ``torch.equal``; after step 1
    the params, and the four ranks' gathered ``m`` and ``v`` chunks, equal
    to zero.py's formula recomputed in plain ops over the full vector from
    the step's averaged grads (``step1_equal``)."""

    def __init__(self):
        self.params_equal: list = []
        self.step1_equal: Optional[list] = None
        self._orig = AdamWZero1.step
        watch = self

        def step(opt, flat, state):
            return watch._observe(opt, flat, state)

        AdamWZero1.step = step

    def close(self) -> None:
        AdamWZero1.step = self._orig

    def _gathered(self, opt, chunk: torch.Tensor, n: int) -> torch.Tensor:
        full = chunk.new_empty(opt.world * chunk.numel())
        collectives._all_gather(full, chunk, group=opt.group)
        return full[:n]

    def _observe(self, opt, flat, state):
        first = self.step1_equal is None
        if first:
            p = flat.params.to(torch.float32, copy=True)   # the step updates params in place
            g = flat.grads.to(torch.float32, copy=True)
            lr = resolve_lr(opt.learning_rate, state.count)
        new = self._orig(opt, flat, state)
        if opt.world == 1:
            self.params_equal.append(True)
        else:
            ref = flat.params.clone()
            dist.broadcast(ref, 0, group=opt.group)
            differ = torch.tensor([0 if torch.equal(ref, flat.params) else 1])
            dist.all_reduce(differ, group=opt.group)
            self.params_equal.append(int(differ) == 0)
            del ref
        if first:
            def like(x):
                return torch.tensor(x, dtype=torch.float32, device=p.device)

            zero = torch.zeros_like(p)
            m = zero * like(opt.b1) + g * like(1.0 - opt.b1)
            v = zero * like(opt.b2) + g * like(1.0 - opt.b2) * g
            tf = (state.count + 1).to(torch.float32)
            mhat = m / (1.0 - like(opt.b1) ** tf)
            vhat = v / (1.0 - like(opt.b2) ** tf)
            p_ref = p - lr * (mhat / (torch.sqrt(vhat) + like(opt.eps))
                              + p * like(opt.weight_decay))
            self.step1_equal = [torch.equal(flat.params, p_ref.to(flat.params.dtype)),
                                torch.equal(self._gathered(opt, new.m, p.numel()), m),
                                torch.equal(self._gathered(opt, new.v, p.numel()), v)]
            del p, g, zero, m, v, mhat, vhat, p_ref
        return new


def r_run(rank: int) -> dict:
    """Run (r) on one rank of the W4 spawn: ZeRO-1 AdamW (``R_ARGS``),
    R_STEPS steps, under a :class:`ZeroWatch`: params equal on every rank
    after every step, step 1 equal to zero.py's formula over the full
    vector, each rank's ``m`` and ``v`` float32 ``[zero1_chunk(N, 4)]``,
    finite losses, no optimizer kernel and (f)'s flash launches; the
    state's bytes a rank beside the replicated AdamW's."""
    watch = ZeroWatch()
    reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run_clm.main(R_ARGS + ["--max_steps", str(R_STEPS)])
    finally:
        watch.close()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect(f"(r) rank {rank}", launches, dict(optimizer_launches(trainer, R_STEPS),
                                              **flash_launches(R_STEPS, accum=1, eval_batches=0,
                                                             layers=W4_LAYERS)))
    rows = [r for r in trainer.history if "loss" in r]
    st = trainer.state
    chunk = zero1_chunk(N_W4, W4)
    rec = {"run": "zero1", "losses": [r["loss"] for r in rows],
           "step_ms": [r["step_ms"] for r in rows], "params_equal": watch.params_equal,
           "step1_equal": watch.step1_equal,
           "state": [[list(st.m.shape), str(st.m.dtype)], [list(st.v.shape), str(st.v.dtype)]],
           "state_bytes": st.m.numel() * st.m.element_size() + st.v.numel() * st.v.element_size(),
           "launches": launches, "wall_s": wall}
    if not (len(rows) == R_STEPS and all(map(math.isfinite, rec["losses"]))
            and watch.params_equal == [True] * R_STEPS and watch.step1_equal == [True] * 3
            and rec["state"] == [[[chunk], "torch.float32"]] * 2
            and isinstance(st, Zero1State) and int(st.count) == R_STEPS):
        raise AssertionError(f"run (r) rank {rank}: {rec}")
    del trainer, st
    torch.cuda.empty_cache()
    return rec


def r_report(rec: dict, card: str) -> None:
    adamw_bytes = 2 * 4 * N_W4
    print(f"[w4] (r) --zero1 (AdamW, gradient all_reduce): {W4_GPT2}, {W4} ranks on one card "
          f"(gloo), B 2 x accum 1 x T 1024, {R_STEPS} steps: losses "
          f"{[round(x, 4) for x in rec['losses']]}; params equal on all ranks after each step "
          f"{rec['params_equal']}; step 1 == zero.py's formula over the full vector (params, "
          f"gathered m, gathered v) {rec['step1_equal']}; m, v {rec['state']} a rank: "
          f"{rec['state_bytes']:,} bytes ({rec['state_bytes'] / 1e6:.1f} MB) of optimizer state a "
          f"rank, against the replicated AdamW's {adamw_bytes:,} ({adamw_bytes / 1e6:.1f} MB); "
          f"step ms {rec['step_ms']}; run_clm.main {rec['wall_s']:.1f} s on {card}; rank 0 "
          f"launches {rec['launches']}", flush=True)


@contextlib.contextmanager
def llama_cut(**over):
    """``LlamaConfig.named`` gives its preset with ``over`` replaced (the
    depth a run is cut to, the vocabulary) while the block runs: the CLIs
    have no flag for the depth."""
    named = LlamaConfig.__dict__["named"]
    LlamaConfig.named = classmethod(
        lambda cls, name, **kw: dataclasses.replace(named.__func__(cls, name, **kw), **over))
    try:
        yield
    finally:
        LlamaConfig.named = named


@contextlib.contextmanager
def gpt2_cut(n_layer: int):
    """``GPT2Config.gpt2_124m`` gives GPT-2 124M's widths at ``n_layer``
    blocks while the block runs (the CLIs have no flag for the depth)."""
    full = GPT2Config.__dict__["gpt2_124m"]
    GPT2Config.gpt2_124m = staticmethod(lambda **kw: GPT2Config(**({"n_layer": n_layer} | kw)))
    try:
        yield
    finally:
        GPT2Config.gpt2_124m = full


def adapter_dim(name: str):
    """The tensor split of adapter factor ``path/A`` or ``path/B`` over a
    Llama base (``models.lora.lora_adapter_specs``)."""
    path, factor = name.rsplit("/", 1)
    dim = tpar.llama_shard_dim(path)
    if factor == "A":
        return 0 if dim == 0 else None
    return dim if dim is not None and dim >= 1 else None


def dense_grad(trainer, local, whole: torch.Tensor, sft: Optional[dict], attn: str = "xla",
               vocab_chunks: int = 0, names: Optional[list] = None,
               shapes: Optional[list] = None) -> list:
    """The unsplit model's gradient on this data rank's microbatch ``local``
    (its whole rows) at the whole-leaf params ``whole`` (the trainer's flat
    order), one tensor a leaf: GPT-2 or Llama with every leaf a parameter
    (Llama's views of ``whole``; with ``vocab_chunks`` its head chunked as
    the run's), or the LoRA adapters over the whole NF4 base ``sft["base"]``
    with this step's adapter-dropout seed. Its attention is ``attn``:
    ``attention_xla``, which launches no counted kernel, or the flash
    kernels where the scores would not fit beside the ranks' state (the
    caller takes their launches back out). ``names`` and ``shapes`` (default
    the trainer's) say what ``whole`` holds: a pipelined run's every stage's
    leaves."""
    names, shapes = names or trainer.flat.names, shapes or trainer.full_shapes
    sizes = [math.prod(sh) for sh in shapes]
    views = {n: t.view(sh) for n, t, sh in zip(names, whole.split(sizes), shapes)}
    tokens = local
    if sft is not None:
        adapters: dict = {}
        for n, t in views.items():
            path, k = n.rsplit("/", 1)
            adapters.setdefault(path, {})[k] = t.clone().requires_grad_()
        seed = train_loop.fold_seed(trainer.cfg.seed + 1, trainer.rank, trainer.step_count, 0)
        model = Llama(dataclasses.replace(sft["cfg"], attn_impl=attn), sft["base"])
        eff = apply_adapters(sft["base"], adapters, LoraConfig(**sft.get("lora", T_LORA)),
                             dropout_seed=seed)
        loss, _ = clm_loss_and_metrics(model(tokens, eff), tokens)
        loss.backward()
        return [adapters[n.rsplit("/", 1)[0]][n.rsplit("/", 1)[1]].grad for n in names]
    if isinstance(trainer.model, (GPT2, GPT2Stage)):
        model = GPT2(dataclasses.replace(trainer.model.cfg, attn_impl=attn), device=whole.device)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(views[n])
        logits, aux = model(tokens, None, return_aux=True)
        loss, _ = clm_loss_and_metrics(logits, tokens)
        if model.cfg.moe_experts:   # GPT-2-MoE's loss at ep 1 (train/loop.py)
            loss = loss + AUX_WEIGHT * aux
        loss.backward()
        named = dict(model.named_parameters())
    else:
        model = Llama(dataclasses.replace(trainer.model.cfg, attn_impl=attn),
                      as_parameters(tree_from_state_dict(views)))
        if vocab_chunks:
            loss, _ = chunked_clm_loss_and_metrics(model.hidden(tokens),
                                                   model.params["lm_head"], tokens,
                                                   vocab_chunks, emb_layout="dv")
        else:
            loss, _ = clm_loss_and_metrics(model(tokens), tokens)
        loss.backward()
        named = dict(model.jax_named_parameters())
    return [named[n].grad for n in names]


def momentum_vs_grad(grads: list, momentum: torch.Tensor, b2: float) -> dict:
    """dp x tp == dp: each leaf's momentum step ``(1 − β₂)·g`` against
    ``(1 − β₂)·`` the unsplit model's gradient, in float32 a leaf at a
    time: the median ratio over the coordinates above 1e-6 or, in a leaf
    with fewer than 8 of those (LoRA's A: its gradient scales with B), above
    1e-3 of the leaf's largest (over an even stride of at most
    MEDIAN_COORDS of them); the leaves with fewer than 8 either way
    (``skipped``: the check fails on any), the largest absolute difference
    and the share of equal ballots ``sign(g)``; ``per_leaf``, each leaf's
    median ratio in order (None where skipped)."""
    ratios, worst, diff, top, equal, skipped = [], (0.0, -1), 0.0, 0.0, 0, 0
    per_leaf = []
    sizes = [g.numel() for g in grads]
    for g, m in zip(grads, momentum.split(sizes)):
        a, b = g.reshape(-1).float() * (1.0 - b2), m.float()
        big = torch.nonzero(a.abs() > 1e-6).flatten()
        if big.numel() < 8:
            big = torch.nonzero(a.abs() > 1e-3 * a.abs().max()).flatten()
        if big.numel() >= 8:
            big = big[::max(1, big.numel() // MEDIAN_COORDS)]
            ratios.append(float(torch.median(b[big] / a[big])))
            worst = max(worst, (abs(ratios[-1] - 1), len(ratios) + skipped - 1))
            per_leaf.append(ratios[-1])
        else:
            skipped += 1
            per_leaf.append(None)
        diff = max(diff, float((b - a).abs().max()))
        top = max(top, float(a.abs().max()))
        equal += int(((b > 0) == (a > 0)).sum())
        del a, b, big
    return {"median_ratio": [min(ratios, default=math.nan), max(ratios, default=math.nan)],
            "leaves": len(ratios), "skipped": skipped, "worst_leaf": worst[1],
            "max_abs_diff": diff, "max_abs": top,
            "equal_ballots": equal / sum(sizes), "per_leaf": per_leaf}


class GridWatch:
    """Checks around ``DistributedLion.step`` in a tensor-, sequence- or
    expert-parallel run, on every rank (the trainer and this rank's
    microbatch read from ``Trainer._train_step``; under a seq or expert axis
    the data rank's whole rows from ``Trainer._local_batch``): after every
    step this rank's leaves replicated over the tensor axis equal its tensor
    peer's and those replicated over the expert axis its expert peer's
    (``replicated_equal``), ``torch.equal``, and its params and momentum hash (sha256) to its seq
    peers' (``seq_equal``), and under a pipe axis its replicated leaves hash to
    every stage's (``pipe_equal``); up to PLAIN_APPLY_MAX coordinates, every step's
    params and momentum equal the plain apply (``fused_apply_plain``) of the
    plain election of the data group's gathered ballots (``apply_equal``),
    the params the other data rank's (``params_equal``), and with telemetry
    the frame's margin histogram and disagreement ``bucket_vote_stats_plain``
    of the gathered tally (``hist``); and dp x tp x sp == dp at step 1 (at
    the last step for LoRA: B is zero until a step with lr > 0 moves it, and
    run_sft's warmup gives step 1 lr 0, so A's gradient is zero at steps 1
    and 2; never with ``check`` False): the momentum step ``m − β₂·m_before
    = (1 − β₂)·g`` gathered over the tensor group into the whole leaves
    against ``(1 − β₂)·`` the unsplit model's gradient on the same rows and
    weights (``dense_grad`` through ``attn``, its flash launches taken back
    out of the counts), one data rank at a time, on its tensor, seq and
    expert rank 0 (``momentum_vs_grad``: ``dp``); under a pipe axis every
    stage's leaves, gathered to stage 0, against the whole unsplit model."""

    def __init__(self, sft: Optional[dict] = None, check: bool = True, attn: str = "xla",
                 vocab_chunks: int = 0, steps: int = S_STEPS):
        self.sft, self.attn, self.vocab_chunks = sft, attn, vocab_chunks
        self.check_step = None if not check else steps - 1 if sft is not None else 0
        self.params_equal, self.replicated_equal, self.apply_equal = [], [], []
        self.seq_equal, self.hist, self.pipe_equal = [], [], []
        self.dp = None
        self.trainer = self.local = self.rows = None
        self._step, self._train_step = DistributedLion.step, train_loop.Trainer._train_step
        self._local_batch = train_loop.Trainer._local_batch
        watch = self

        def step(opt, flat, state):
            return watch._observe(opt, flat, state)

        def train_step(trainer, local):
            watch.trainer, watch.local = trainer, local
            return watch._train_step(trainer, local)

        def local_batch(trainer, batch):
            if trainer.seq.size > 1 or trainer.expert.size > 1:   # the data rank's whole rows
                n = (trainer.cfg.gradient_accumulation_steps
                     * trainer.cfg.per_device_train_batch_size * trainer.expert.size)
                watch.rows = train_loop._to_device(
                    train_loop._rows(batch, trainer.rank * n, (trainer.rank + 1) * n),
                    trainer.device)
            return watch._local_batch(trainer, batch)

        DistributedLion.step = step
        train_loop.Trainer._train_step = train_step
        train_loop.Trainer._local_batch = local_batch

    def close(self) -> None:
        DistributedLion.step = self._step
        train_loop.Trainer._train_step = self._train_step
        train_loop.Trainer._local_batch = self._local_batch

    def _observe(self, opt, flat, state):
        tr = self.trainer
        plain = flat.numel <= PLAIN_APPLY_MAX
        first = state.steps == self.check_step
        # builds the unsplit model
        checker = tr.tensor.rank == 0 and tr.seq.rank == 0 and tr.expert.rank == 0
        if plain:
            g = flat.grads.to(state.exp_avg.dtype)
            ballots = fused_lion.fused_ballots_plain(g, state.exp_avg, opt.b1)
            gathered = [torch.empty_like(ballots) for _ in range(opt.world)]
            dist.all_gather(gathered, ballots, group=opt.group)
            _, tally = plain_election(gathered, opt.wire)
            want = fused_lion.fused_apply_plain(flat.params, g, state.exp_avg, tally,
                                                resolve_lr(opt.learning_rate, state.count),
                                                opt.weight_decay, opt.b2)
            del g, gathered
        before = tr._whole(flat.params) if first else None
        if before is not None and tr.tensor.size == 1:
            before = before.clone() if checker else None   # the step updates it in place
        if not checker:
            before = None
        # the step may update the momentum in place; step 1's before is zero
        m_before = state.exp_avg.clone() if first and self.check_step else None
        out = self._step(opt, flat, state)
        # (state, *frames) with telemetry; a state alone is a NamedTuple
        st, frame = (out[0], out[1]) if type(out) is tuple else (out, None)
        if plain:
            self.apply_equal.append(torch.equal(flat.params, want[0])
                                    and torch.equal(st.exp_avg, want[1]))
            if frame is not None and opt.wire == "sign_psum":
                hist, dis = fused_lion.bucket_vote_stats_plain(ballots, tally, opt.world, 8)
                self.hist.append(frame["margin_hist"].tolist() == hist.tolist()
                                 and int(frame["disagree"]) == int(dis))
            del want, ballots, tally
            # over PLAIN_APPLY_MAX the broadcast would take seconds a step
            self.params_equal.append(self._equal_to(flat.params, opt.group))
        equal = True
        for axis, dims in ((tr.tensor, tr._dims), (tr.expert, tr._edims)):
            if axis.size > 1:
                views = flat.views(flat.params)
                rep = torch.cat([views[n].reshape(-1) for n, d in zip(flat.names, dims)
                                 if d is None])
                equal = self._equal_to(rep, axis.group) and equal
                del rep
        self.replicated_equal.append(equal)
        if tr.seq.size > 1:
            self.seq_equal.append(self._hash_equal((flat.params, st.exp_avg), tr.seq))
        if tr.pipe.size > 1:   # wte, wpe and ln_f (Llama's lm_head) on every stage
            views = flat.views(flat.params)
            self.pipe_equal.append(self._hash_equal(
                [views[n] for n, split in zip(flat.names, tr._pdims) if not split], tr.pipe))
        if first:
            self.dp = self._dp_check(tr, opt, before, st.exp_avg, m_before)
        del before, m_before
        torch.cuda.empty_cache()
        return out

    @staticmethod
    def _hash_equal(tensors, axis) -> bool:
        """The sha256 of ``tensors`` the same on every rank of ``axis``'s
        group, hashed a chunk at a time: at (w)'s and (z4)'s 1.49B
        coordinates whole host copies on four ranks would fill the host."""
        digest = hashlib.sha256()
        for t in tensors:
            b = t.detach().reshape(-1).view(torch.uint8)
            for i in range(0, b.numel(), HASH_CHUNK):
                digest.update(b[i:i + HASH_CHUNK].cpu().numpy())
        every = [None] * axis.size
        dist.all_gather_object(every, digest.hexdigest(), group=axis.group)
        return len(set(every)) == 1

    @staticmethod
    def _stages(tr, before, m) -> tuple:
        """Every stage's leaf names, whole shapes, params before the step and
        momentum step, gathered to stage 0 (a replicated leaf once): ``(names,
        shapes, before, m)`` there, Nones elsewhere."""
        every = [None] * tr.pipe.size if tr.pipe.rank == 0 else None
        mine = (tr.flat.names, tr.full_shapes, None if before is None else before.cpu(),
                m.cpu())
        dist.gather_object(mine, every, dst=dist.get_global_rank(tr.pipe.group, 0),
                           group=tr.pipe.group)
        if tr.pipe.rank or before is None:
            return None, None, None, None
        seen, names, shapes, ps, ms = set(), [], [], [], []
        for stage_names, stage_shapes, b, mm in every:
            sizes = [math.prod(x) for x in stage_shapes]
            for name, shape, bp, mp in zip(stage_names, stage_shapes, b.split(sizes),
                                           mm.split(sizes)):
                if name not in seen:
                    seen.add(name)
                    names.append(name)
                    shapes.append(shape)
                    ps.append(bp)
                    ms.append(mp)
        return names, shapes, torch.cat(ps).to(m.device), torch.cat(ms).to(m.device)

    @staticmethod
    def _equal_to(t: torch.Tensor, group) -> bool:
        """``t`` equals the first rank's of ``group`` on every rank of it."""
        ref = t.clone()
        dist.broadcast(ref, dist.get_global_rank(group, 0), group=group)
        differ = torch.tensor([0 if torch.equal(ref, t) else 1])
        dist.all_reduce(differ, group=group)
        return int(differ) == 0

    def _dp_check(self, tr, opt, before, momentum, m_before) -> dict:
        """One data rank at a time, on its tensor and seq rank 0 (the
        unsplit model is large); every rank gets its data rank's record."""
        out = None
        for d in range(tr.world):
            if d == tr.rank:
                m = tr._whole(momentum)
                if self.check_step:   # the momentum before step 1 is zero
                    m = m - opt.b2 * tr._whole(m_before)
                names = shapes = None
                if tr.pipe.size > 1:
                    names, shapes, before, m = self._stages(tr, before, m)
                if before is not None:
                    counts = read_counts()
                    rows = self.rows if tr.seq.size > 1 or tr.expert.size > 1 else self.local
                    out = momentum_vs_grad(dense_grad(tr, rows, before, self.sft, self.attn,
                                                      self.vocab_chunks, names, shapes),
                                           m, opt.b2)
                    names = names or tr.flat.names
                    out["worst_leaf"], out["all_leaves"] = names[out["worst_leaf"]], len(names)
                    out["per_leaf"] = dict(zip(names, out["per_leaf"]))
                    restore_counts(counts)
                del m
                torch.cuda.empty_cache()
            dist.barrier()
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (tr.rank, out))
        return next(o for r, o in every if r == tr.rank and o is not None)


def tp_eval_batches(trainer, rows: int) -> int:
    """The eval batches ``Trainer.evaluate`` takes over ``rows`` rows, split
    over the data ranks' row shards (under an expert axis each expert rank
    takes its own)."""
    per_dev, shards = trainer.cfg.per_device_eval_batch_size, trainer._row_shards
    if rows < shards * per_dev:
        per_dev = rows // shards
    return 0 if per_dev == 0 else min(trainer.cfg.eval_iters, rows // (shards * per_dev))


def tp_flash_launches(layers: int, steps: int, evals: int, hd: int) -> dict:
    """A tensor-parallel run's flash launches a rank (accum 1): its heads'
    forward twice a microbatch (remat) and once an eval batch."""
    sfx = "" if hd == 64 else "_hd128"
    return {"flash_attention_fwd" + sfx: layers * (2 * steps + evals),
            "flash_attention_bwd_dkv" + sfx: layers * steps,
            "flash_attention_bwd_dq" + sfx: layers * steps,
            "flash_attention_di" + sfx: layers * steps,
            **(NO_HD128 if hd == 64 else NO_HD64)}


def grid_one(rank: int, label: str, run, n_local: int, flash, dp_world: int = 2,
             sft: Optional[dict] = None, tol: float = MEDIAN_TOL, steps: int = S_STEPS,
             **watch_kw) -> dict:
    """One tensor-, sequence- or expert-parallel run of ``steps`` steps under
    a :class:`GridWatch` (``watch_kw`` its options): ``run()`` returns
    (trainer, the eval rows it evaluated, the run's base tree or None);
    checks every rank's record and its launches a rank (the optimizer
    kernels' by formula, the flash kernels' ``flash(eval batches)``); the dp
    check's median ratios within ``tol`` of 1."""
    watch = GridWatch(sft, steps=steps, **watch_kw)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        trainer, eval_rows, base = run()
    finally:
        watch.close()
    wall = time.perf_counter() - t0
    launches, peak = read_counts(), torch.cuda.max_memory_allocated()
    rows = [r for r in trainer.history if "loss" in r]
    evals = tp_eval_batches(trainer, eval_rows)
    expect(f"{label} rank {rank}", launches, dict(optimizer_launches(trainer, steps),
                                                  **flash(evals)))
    losses = [r["loss"] for r in rows]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (trainer.rank, losses))   # the data rank's ranks agree
    plain = trainer.n_params <= PLAIN_APPLY_MAX
    sp = trainer.seq.size
    rec = {"run": label, "losses": losses, "step_ms": [r["step_ms"] for r in rows],
           "n_params": trainer.n_params, "n_global": trainer.n_global,
           "buckets": trainer.cfg.vote_buckets, "evals": evals,
           "losses_equal": all(l == losses for d, l in every if d == trainer.rank),
           "params_equal": watch.params_equal, "replicated_equal": watch.replicated_equal,
           "apply_equal": watch.apply_equal, "seq_equal": watch.seq_equal, "hist": watch.hist,
           "pipe_equal": watch.pipe_equal,
           "dp": watch.dp, "dp_step": None if watch.check_step is None else watch.check_step + 1,
           "peak_gib": peak / 2**30, "rss_gib": peak_rss_bytes() / 2**30, "wall_s": wall,
           "launches": launches, "comm": trainer.comm_stats().get("comm_bytes_per_step")}
    if base is not None:   # (t): the rank's NF4 codes and absmax, slices of the whole base
        whole = dict(iter_paths(sft["base"]))
        mine = dict(iter_paths(base))
        rec["nf4_equal"] = all(
            torch.equal(q.codes, tpar.shard(whole[p], tpar.llama_shard_dim(".".join(p)), TP,
                                            trainer.tensor.rank).codes)
            and torch.equal(q.absmax, tpar.shard(whole[p], tpar.llama_shard_dim(".".join(p)),
                                                 TP, trainer.tensor.rank).absmax)
            for p, q in mine.items() if isinstance(q, quant.QuantizedTensor))
    dp = watch.dp
    ok = (len(rows) == steps and all(map(math.isfinite, rec["losses"]))
          and trainer.n_params == n_local and trainer.world == dp_world and rec["losses_equal"]
          and watch.params_equal == watch.apply_equal == ([True] * steps if plain else [])
          and watch.replicated_equal == [True] * steps
          and watch.seq_equal == ([True] * steps if sp > 1 else [])
          and watch.pipe_equal == ([True] * steps if trainer.pipe.size > 1 else [])
          and all(watch.hist) and (len(watch.hist) == steps) == (
              plain and trainer.cfg.telemetry)
          and (watch.check_step is None or (
              dp is not None and dp["skipped"] == 0
              and dp["leaves"] == dp["all_leaves"] and dp["equal_ballots"] >= 0.99
              and abs(dp["median_ratio"][0] - 1) < tol
              and abs(dp["median_ratio"][1] - 1) < tol))
          and rec.get("nf4_equal", True))
    if not ok:
        raise AssertionError(f"run {label} rank {rank}: {rec}")
    del trainer
    torch.cuda.empty_cache()
    return rec


def tp_runs(rank: int) -> dict:
    """Runs (s1), (s2), (t) and (u) on one rank of the W4 spawn (dp 2 x tp
    2); rank 0 returns the records."""
    def clm(args):
        def run():
            trainer = run_clm.main(args)
            return trainer, 3, None   # 5% of 64 synthetic blocks held out
        return run

    def flash(layers, hd, steps=S_STEPS):
        return lambda evals: tp_flash_launches(layers, steps, evals, hd)

    recs = [grid_one(rank, "(s1)", clm(S1_ARGS), N_TP, flash(W4_LAYERS, 64)),
            grid_one(rank, "(s2)", clm(S2_ARGS), N_TP_VOCAB, flash(W4_LAYERS, 64))]
    with llama_cut(n_layer=T_LAYERS, vocab_size=T_VOCAB):
        cfg = LlamaConfig.named(T_MODEL, attn_impl="flash")
        sft = {"cfg": cfg, "base": llama_init(cfg, seed=42, device=TP_DEVICE, quant="nf4")}

        def t_run():
            trainer, model, _ = run_sft.main(T_ARGS)
            args = run_sft.SFTArguments(seq_length=1024)
            train, valid = run_sft.sft_records(args)
            _, ev = run_sft.sft_batches(args, ByteTokenizer(), train, valid,
                                        trainer.global_train_batch(), trainer.cfg.seed, 1.0)
            return trainer, len(ev), model.params

        recs.append(grid_one(rank, "(t)", t_run, N_TP_SFT, flash(T_LAYERS, 128, LORA_STEPS),
                             sft=sft, steps=LORA_STEPS))
        del sft
        torch.cuda.empty_cache()
    with llama_cut(n_layer=U_LAYERS):
        recs.append(grid_one(rank, "(u)", lambda: (run_clm.main(U_ARGS), 0, None),
                             N_TP_LLAMA3, flash(U_LAYERS, 128)))
    return {"run": "tp", "records": recs}


def tp_report(rec: dict, card: str) -> None:
    what = {"(s1)": f"run_clm {W4_GPT2}, --dropout 0 --tensor_parallel {TP}",
            "(s2)": f"(s1) + --tp_vocab --vocab_pad_multiple 64",
            "(t)": f"run_sft Llama-2-7B widths at {T_LAYERS} layers, vocabulary {T_VOCAB:,}, NF4 "
                   f"base, LoRA r 8 on wq/wv, --tensor_parallel {TP}",
            "(u)": f"run_clm --model_family llama, Llama-3-8B widths at {U_LAYERS} layers, bf16, "
                   f"T {U_T}, --tensor_parallel {TP} --tp_vocab"}
    for r in rec["records"]:
        dp = r["dp"]
        print(f"[w4] {r['run']} {what[r['run']]}: dp 2 x tp 2, 4 ranks on one card (gloo), "
              f"{r['n_params']:,} coordinates a rank of {r['n_global']:,}, {r['buckets']} "
              f"bucket(s), {r['evals']} eval batch(es): losses "
              f"{[round(x, 4) for x in r['losses']]}, equal across the tensor ranks "
              f"{r['losses_equal']}; params equal across the data ranks after each step "
              f"{r['params_equal'] or 'not checked (over PLAIN_APPLY_MAX)'}; replicated leaves equal across the tensor ranks after each "
              f"step {r['replicated_equal']}; plain apply of the plain election equal "
              f"{r['apply_equal'] or 'not run (over PLAIN_APPLY_MAX)'}"
              + (f"; NF4 codes and absmax == the slices of the whole base {r['nf4_equal']}"
                 if "nf4_equal" in r else "")
              + f"; dp x tp == dp at step {r['dp_step']} (rank 0): per-leaf "
              f"median momentum ratio in [{dp['median_ratio'][0]:.6f}, "
              f"{dp['median_ratio'][1]:.6f}] over {dp['leaves']} leaves ({dp['skipped']} "
              f"skipped), max |diff| {dp['max_abs_diff']:.3e} (max |m| {dp['max_abs']:.3e}), equal "
              f"ballots {dp['equal_ballots']:.6f}; analytic wire {r['comm']} bytes/step (the "
              f"whole model's count, as the JAX package states it); step ms {r['step_ms']}; peak "
              f"device memory {r['peak_gib']:.2f} GiB a rank; main {r['wall_s']:.1f} s on {card}; "
              f"rank 0 launches {r['launches']}", flush=True)


def no_flash(evals: int) -> dict:
    """A sequence-parallel run's flash launches: none (every attention of it,
    eval's too, is the ring's or Ulysses')."""
    return {**NO_HD64, **NO_HD128}


def sp_runs(rank: int) -> dict:
    """Runs (v1)-(x2) on one rank of the W4 spawn (dp 2 x sp 2; (v3) dp 1 x
    tp 2 x sp 2; (w) dp 1 x sp 4); rank 0 returns the records."""
    def clm(args):
        return lambda: (run_clm.main(args), 3, None)   # 5% of 64 synthetic blocks held out

    recs = [grid_one(rank, "(v1)", clm(V1_ARGS), N_W4, no_flash, tol=MEDIAN_TOL_F32),
            grid_one(rank, "(v2)", clm(V2_ARGS), N_W4, no_flash, tol=MEDIAN_TOL_F32),
            grid_one(rank, "(v3)", clm(V3_ARGS), N_TP, no_flash, dp_world=1,
                     tol=MEDIAN_TOL_F32)]
    with llama_cut(n_layer=W_LAYERS):
        # the unsplit check model's scores at T 8192 would not fit beside the
        # four ranks' state: it takes the flash kernels
        recs.append(grid_one(rank, "(w)", lambda: (run_clm.main(W_ARGS), 1, None), N_SP_LLAMA3,
                             no_flash, dp_world=1, attn="flash", vocab_chunks=W_CHUNKS))
    torch.cuda.empty_cache()
    with llama_cut(n_layer=X1_LAYERS, vocab_size=T_VOCAB):
        cfg = LlamaConfig.named(T_MODEL)
        sft = {"cfg": cfg, "base": llama_init(cfg, seed=42, device=TP_DEVICE, quant="nf4"),
               "lora": dict(T_LORA, dropout=0.0)}
        recs.append(grid_one(rank, "(x1)", lambda: (run_sft.main(X1_ARGS)[0], 0, None),
                             N_SP_SFT, no_flash, sft=sft, steps=LORA_STEPS))
        del sft
        torch.cuda.empty_cache()
    with llama_cut(n_layer=X2_LAYERS):
        recs.append(grid_one(rank, "(x2)", lambda: (run_dpo.main(X2_ARGS)[0], 0, None),
                             N_SP_DPO, no_flash, check=False))
    return {"run": "sp", "records": recs, "wire": seq_wire_times()}


def seq_wire_times() -> dict:
    """Host-clock ms (median of 5 after a warm-up, each ended by a
    synchronize) of the seq axis's two collectives at (v1)'s shapes on its dp
    2 x sp 2 grid, through gloo: the gradient's ``all_reduce`` over the seq
    pair (N_W4 float32) and one ring hop of a layer's stacked k and v (``[2,
    2, 12, 512, 64]`` float32, ``parallel.ring_attention._shift``)."""
    from distributed_lion_tpu_torch.parallel.ring_attention import _shift

    grid = make_grid(1, sp=SP)
    grads = torch.ones(N_W4, device="cuda")
    kv = torch.ones(2, 2, 12, 1024 // SP, 64, device="cuda")
    out = {}
    for name, fn in (("grad_all_reduce_ms",
                      lambda: dist.all_reduce(grads, group=grid.seq.group)),
                     ("ring_hop_ms", lambda: _shift(kv, grid.seq, 1))):
        times = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
        out[name] = statistics.median(times)
    return out


def sp_report(rec: dict, card: str) -> None:
    what = {"(v1)": f"run_clm {W4_GPT2}, T 1024, dp 2 x sp {SP}, ring, --dropout 0 "
                    "--telemetry",
            "(v2)": f"(v1) with --seq_impl ulysses, no --telemetry",
            "(v3)": f"run_clm {W4_GPT2}, T 1024, dp 1 x tp {TP} x sp {SP}, ring",
            "(w)": f"run_clm --model_family llama, Llama-3-8B widths at {W_LAYERS} layers, bf16, "
                   f"T {W_T}, dp 1 x sp {W_SP}, ring, --vocab_chunks {W_CHUNKS}",
            "(x1)": f"run_sft --packing, Llama-2-7B widths at {X1_LAYERS} layers, vocabulary "
                    f"{T_VOCAB:,}, NF4 base, LoRA r 8 on wq/wv, T 2048, dp 2 x sp {SP}",
            "(x2)": f"run_dpo, Llama-2-7B widths at {X2_LAYERS} layers, --max_length 1024, "
                    f"dp 2 x sp {SP}"}
    for r in rec["records"]:
        dp = r["dp"]
        check = ("no dp check" if dp is None else
                 f"sp == dp at step {r['dp_step']} (rank 0's data rank): per-leaf median momentum "
                 f"ratio in [{dp['median_ratio'][0]:.6f}, {dp['median_ratio'][1]:.6f}] over "
                 f"{dp['leaves']} leaves ({dp['skipped']} skipped; farthest from 1: "
                 f"{dp['worst_leaf']}), max |diff| "
                 f"{dp['max_abs_diff']:.3e} (max |m| {dp['max_abs']:.3e}), equal ballots "
                 f"{dp['equal_ballots']:.6f}")
        print(f"[w4] {r['run']} {what[r['run']]}: 4 ranks on one card (gloo), "
              f"{r['n_params']:,} coordinates a rank of {r['n_global']:,}, {r['buckets']} "
              f"bucket(s), {r['evals']} eval batch(es): losses "
              f"{[round(x, 4) for x in r['losses']]}, equal across the data rank's ranks "
              f"{r['losses_equal']}; params and momentum sha256-equal across the seq ranks after "
              f"each step {r['seq_equal']}; replicated leaves equal across the tensor ranks "
              f"{r['replicated_equal']}; params equal across the data ranks "
              f"{r['params_equal'] or 'not checked (over PLAIN_APPLY_MAX)'}; plain apply of the "
              f"plain election equal {r['apply_equal'] or 'not run (over PLAIN_APPLY_MAX)'}"
              + (f"; margin histogram and disagreement == bucket_vote_stats_plain of the gathered "
                 f"tally at each step {r['hist']}" if r["hist"] else "")
              + f"; {check}; step ms {r['step_ms']}; peak device memory {r['peak_gib']:.2f} GiB "
              f"a rank, rank 0's process peak host RSS so far {r['rss_gib']:.2f} GiB; main "
              f"{r['wall_s']:.1f} s on {card}; rank 0 launches {r['launches']}",
              flush=True)
    print(f"[w4] seq axis collectives through gloo on one card (host clock, rank 0, median of "
          f"5): the gradient's all_reduce over the seq pair, {N_W4:,} float32, "
          f"{rec['wire']['grad_all_reduce_ms']:.1f} ms; one ring hop of a layer's k and v at "
          f"(v1)'s shape, {rec['wire']['ring_hop_ms']:.2f} ms; on {card}", flush=True)


class RingWatch:
    """Around ``Trainer._train_step`` in a run with the MoE balance ring:
    for each step the ring slot the step reads (``stale``), this rank's
    microbatches' tallies summed and then summed over the expert group by
    the watch itself (``fresh``), and the slot the step wrote
    (``written``)."""

    def __init__(self):
        self.stale, self.fresh, self.written = [], [], []
        self._orig = train_loop.Trainer._train_step
        watch = self

        def step(trainer, local):
            ring = trainer.state.moe_ring
            slot = trainer.state.steps % ring.shape[0]
            watch.stale.append(ring[slot].clone())
            mine, loss_fn = [], trainer.loss_fn

            def counting(batch, seed, *balance):
                loss, metrics = loss_fn(batch, seed, *balance)
                mine.append(metrics["moe_tallies"].clone())
                return loss, metrics

            trainer.loss_fn = counting
            try:
                out = watch._orig(trainer, local)
            finally:
                trainer.loss_fn = loss_fn
            fresh = torch.stack(mine).sum(0)
            dist.all_reduce(fresh, group=trainer.expert.group)
            watch.fresh.append(fresh)
            watch.written.append(trainer.state.moe_ring[slot].clone())
            return out

        train_loop.Trainer._train_step = step

    def close(self) -> None:
        train_loop.Trainer._train_step = self._orig

    def report(self, depth: int) -> dict:
        """Whether each step read the slot of the step ``depth`` before (all
        zeros, the local aux, for the first ``depth``) and wrote its own
        tallies summed over the expert group; the MoE blocks' lane counts
        and whether their expert counts sum to them."""
        steps = len(self.fresh)
        return {
            "cold": [bool((self.stale[t] == 0).all()) for t in range(min(depth, steps))],
            "stale_equal": [torch.equal(self.stale[t], self.fresh[t - depth])
                            for t in range(depth, steps)],
            "written_equal": [torch.equal(w, f) for w, f in zip(self.written, self.fresh)],
            "lanes": sorted({int(x) for f in self.fresh for x in f[:, -1].tolist()}),
            "counts_sum": all(torch.equal(f[:, :-1].sum(-1), f[:, -1]) for f in self.fresh),
            "last": self.fresh[-1].tolist()}


def ep_runs(rank: int) -> dict:
    """Runs (y2) and (y3) on one rank of the W4 spawn (dp 2 x ep 2; dp 1 x tp
    2 x ep 2); rank 0 returns the records."""
    recs = [grid_one(rank, "(y2)", lambda: (run_clm.main(Y2_ARGS), 3, None), N_EP, no_flash,
                     tol=MEDIAN_TOL_F32)]
    ring = {}

    def y3():
        watch = RingWatch()
        try:
            trainer = run_clm.main(Y3_ARGS)
        finally:
            watch.close()
        ring.update(watch.report(Y3_DEPTH))
        return trainer, 3, None

    rec = grid_one(rank, "(y3)", y3, N_EP_TP, lambda evals: tp_flash_launches(
        N_LAYER, Y3_STEPS, evals, 64), dp_world=1, check=False, steps=Y3_STEPS)
    rec["ring"] = ring
    if (ring["cold"] != [True] * Y3_DEPTH or ring["stale_equal"] != [True] * (Y3_STEPS - Y3_DEPTH)
            or ring["written_equal"] != [True] * Y3_STEPS or ring["lanes"] != [Y_LANES]
            or not ring["counts_sum"]):
        raise AssertionError(f"run (y3) rank {rank}: ring {ring}")
    recs.append(rec)
    return {"run": "ep", "records": recs}


def ep_rank(rank: int, tmp: str) -> None:
    """One rank of the expert-parallel spawn: W4 fresh processes on cuda:0 in
    a gloo group of their own (the W4 spawn's ranks hold up to 22 GiB of
    host memory each by its end, and four of them beside (y2)'s whole-model
    draws passed the machine's 96 GiB); rank 0 writes ``tmp/ep.json``."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg_ep", rank=rank,
                            world_size=W4)
    try:
        rec = ep_runs(rank)
        if rank == 0:
            with open(f"{tmp}/ep.json", "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def ep_phase(tmp: str, card: str) -> None:
    """Runs (y2) and (y3) in their own W4 spawn; prints rank 0's records."""
    mp.spawn(ep_rank, args=(tmp,), nprocs=W4, join=True)
    with open(f"{tmp}/ep.json") as f:
        ep_report(json.load(f), card)


def ep_report(rec: dict, card: str) -> None:
    what = {"(y2)": "run_clm GPT-2-MoE (8 experts every 2 blocks), float32 compute, capacity "
                    "factor 8, dp 2 x ep 2, --ep_dcn_pipeline 0",
            "(y3)": "run_clm GPT-2-MoE, bfloat16 compute, capacity factor 1.25, dp 1 x tp 2 x "
                    f"ep 2, --ep_dcn_pipeline {Y3_DEPTH}"}
    for r in rec["records"]:
        dp = r["dp"]
        check = ("no unsplit check" if dp is None else
                 f"ep == the unsplit model on the expert pair's rows at step {r['dp_step']} "
                 f"(rank 0's data rank): per-leaf median momentum ratio in "
                 f"[{dp['median_ratio'][0]:.6f}, {dp['median_ratio'][1]:.6f}] over {dp['leaves']} "
                 f"leaves ({dp['skipped']} skipped; farthest from 1: {dp['worst_leaf']}), max "
                 f"|diff| {dp['max_abs_diff']:.3e} (max |m| {dp['max_abs']:.3e}), equal ballots "
                 f"{dp['equal_ballots']:.6f}")
        ring = r.get("ring")
        ring_text = "" if not ring else (
            f"; ring: steps 1-{Y3_DEPTH} read an all-zero slot (the local aux) {ring['cold']}, "
            f"each later step the tallies of the step {Y3_DEPTH} before summed over the expert "
            f"group {ring['stale_equal']}, each step wrote its own {ring['written_equal']}, lane "
            f"counts {ring['lanes']}, last tallies {ring['last']}")
        print(f"[w4] {r['run']} {what[r['run']]}: 4 ranks on one card (gloo), {r['n_params']:,} "
              f"coordinates a rank of {r['n_global']:,}, {r['buckets']} bucket(s), {r['evals']} "
              f"eval batch(es): losses {[round(x, 4) for x in r['losses']]}, equal across the "
              f"data rank's ranks {r['losses_equal']}; replicated leaves equal across the expert "
              f"(and tensor) ranks after each step {r['replicated_equal']}; {check}{ring_text}; "
              f"step ms {r['step_ms']}; peak device memory {r['peak_gib']:.2f} GiB a rank; main "
              f"{r['wall_s']:.1f} s on {card}; rank 0 launches {r['launches']}", flush=True)


# (label, args, pp, microbatches, a rank's coordinates, data world, unsplit check)
PP_RUNS = (("(z1)", Z1_ARGS, 2, 4, N_PP, 2, True), ("(z2)", Z2_ARGS, 4, 8, N_PP4, 1, True),
           ("(z3)", Z3_ARGS, 2, 4, N_PP_TP, 1, False))


def pp_runs(rank: int) -> dict:
    """Runs (z1)-(z4) on one rank of the pipeline spawn; rank 0 returns the
    records. A rank's flash launches are a tensor-parallel run's over its
    stage's blocks times the microbatches (accum 1): each block's forward
    twice a microbatch (remat), the backward kernels once, and an eval
    batch's microbatches forward."""
    recs = []
    for label, args, pp, micro, n, dp_world, check in PP_RUNS:
        rec = grid_one(rank, label, lambda args=args: (run_clm.main(args), 10, None), n,
                       lambda evals, pp=pp, micro=micro: tp_flash_launches(
                           Z_LAYERS // pp * micro, Z_STEPS, evals, 64),
                       dp_world=dp_world, check=check, steps=Z_STEPS)
        recs.append(dict(rec, pp=pp, micro=micro))
    with llama_cut(n_layer=Z4_LAYERS):
        rec = grid_one(rank, "(z4)", lambda: (run_clm.main(Z4_ARGS), 4, None), N_PP_LLAMA3,
                       lambda evals: tp_flash_launches(Z4_LAYERS // 2 * 2, Z_STEPS, evals, 128),
                       check=False, steps=Z_STEPS)
        recs.append(dict(rec, pp=2, micro=2))
    return {"run": "pp", "records": recs}


def pp_rank(rank: int, tmp: str) -> None:
    """One rank of the pipeline spawn: W4 fresh processes on cuda:0 in a gloo
    group of their own (as the expert-parallel spawn's, for the host's
    memory), its collectives under a 600 s timeout so that a hop made out of
    order fails the run; rank 0 writes ``tmp/pp.json``."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg_pp", rank=rank,
                            world_size=W4, timeout=datetime.timedelta(seconds=600))
    try:
        with gpt2_cut(Z_LAYERS):
            rec = pp_runs(rank)
        if rank == 0:
            with open(f"{tmp}/pp.json", "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def pp_phase(tmp: str, card: str) -> dict:
    """Runs (z1)-(z4) in their own W4 spawn; prints rank 0's records and
    returns its launches summed over the runs, per entry of KERNELS ((z4)'s
    optimizer launches are the all-bfloat16 instantiation's)."""
    mp.spawn(pp_rank, args=(tmp,), nprocs=W4, join=True)
    with open(f"{tmp}/pp.json") as f:
        rec = json.load(f)
    pp_report(rec, card)
    total = dict.fromkeys(KERNELS, 0)
    for r in rec["records"]:
        for k, v in r["launches"].items():
            total[f"{k}_p_bf16" if r["run"] == "(z4)" and k in WRAPPERS
                  and k != "bucket_vote_stats" else k] += v
    return total


def pp_report(rec: dict, card: str) -> None:
    gpt2 = f"GPT-2 124M's widths at {Z_LAYERS} layers"
    what = {"(z1)": f"run_clm {gpt2}, dp 2 x pp 2, 4 microbatches of B 4",
            "(z2)": f"run_clm {gpt2}, dp 1 x pp 4, 8 microbatches of B 8",
            "(z3)": f"run_clm {gpt2}, dp 1 x tp 2 x pp 2, 4 microbatches of B 4",
            "(z4)": f"run_clm --model_family llama, Llama-3-8B widths at {Z4_LAYERS} layers, "
                    f"bf16, T {Z4_T}, --vocab_chunks 8, dp 2 x pp 2, 2 microbatches of B 2"}
    for r in rec["records"]:
        dp = r["dp"]
        check = ("no unsplit check" if dp is None else
                 f"pp == the unsplit model at step {r['dp_step']} (rank 0's data rank, every "
                 f"stage's leaves): per-leaf median momentum ratio in "
                 f"[{dp['median_ratio'][0]:.6f}, {dp['median_ratio'][1]:.6f}] over {dp['leaves']} "
                 f"leaves ({dp['skipped']} skipped; farthest from 1: {dp['worst_leaf']}), max "
                 f"|diff| {dp['max_abs_diff']:.3e} (max |m| {dp['max_abs']:.3e}), equal ballots "
                 f"{dp['equal_ballots']:.6f}")
        print(f"[pp] {r['run']} {what[r['run']]}: 4 ranks on one card (gloo), bubble fraction "
              f"{bubble_fraction(r['pp'], r['micro']):.4f}, {r['n_params']:,} coordinates a "
              f"rank of {r['n_global']:,}, {r['buckets']} bucket(s), {r['evals']} eval "
              f"batch(es): losses {[round(x, 4) for x in r['losses']]}, equal across the data "
              f"rank's ranks {r['losses_equal']}; replicated leaves equal across the stages "
              f"after each step {r['pipe_equal']} (and across the tensor ranks "
              f"{r['replicated_equal']}); plain apply of the plain election equal "
              f"{r['apply_equal'] or 'not run (over PLAIN_APPLY_MAX)'}; {check}; step ms "
              f"{r['step_ms']} (four ranks share the card: not a rate); peak device memory "
              f"{r['peak_gib']:.2f} GiB a rank; main {r['wall_s']:.1f} s on {card}; rank 0 "
              f"launches {r['launches']}", flush=True)


def plane_run(rank: int, tmp: str) -> dict:
    """Run (p) on one rank of the W4 spawn: ``run_clm.main`` with the
    control plane (``P_ARGS``) and the journal, under a :class:`StepWatch`,
    a :class:`HealWatch` and a :class:`BoundaryWatch`. Every step's election
    equal to the plain election under that step's mask (``P_VOTERS``
    voters), the stats kernel's histogram and disagreement equal to
    ``bucket_vote_stats_plain`` of the gathered masked tally; rank 1's
    lifecycle ``P_LIFECYCLE`` at every boundary, the four ranks' boundaries
    equal; rank 1's healed momentum ``torch.equal`` to the healthy mean;
    every row's ``comm_drift_bytes`` and ``host_step_skew`` 0; finite
    losses and momentum; the launches by their formula."""
    watch, heal, bounds = StepWatch(), HealWatch(), BoundaryWatch()
    reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run_clm.main(W4_ARGS + P_ARGS + ["--journal_dir", f"{tmp}/{P_JOURNAL}"])
    finally:
        watch.close()
        heal.close()
        bounds.close()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect(f"(p) rank {rank}", launches,
           dict(optimizer_launches(trainer, P_STEPS),
                **flash_launches(P_STEPS, accum=1, eval_batches=0, layers=W4_LAYERS)))
    rows = [r for r in trainer.history if "loss" in r]
    everyone = [None] * W4
    dist.all_gather_object(everyone, bounds.rows)
    lifecycle = {k: [b[2][1] for b in bounds.rows if b[0] == k] for k in P_LIFECYCLE}
    record = {"run": "control plane", "losses": [r["loss"] for r in rows],
              "step_ms": [r["step_ms"] for r in rows], "voters": watch.voters,
              "hist": watch.hist, "heal_equal": heal.equal, "heal_s": heal.seconds,
              "lifecycle": lifecycle, "final": trainer._cplane.lifecycle(),
              "drift": [r.get("comm_drift_bytes") for r in rows],
              "skew": [r.get("host_step_skew") for r in rows],
              "measured": [r.get("comm_measured_bytes_per_step") for r in rows][:1],
              "launches": launches, "wall_s": wall, "params_equal": watch.params_equal,
              "election_equal": watch.election_equal}
    ok = (len(rows) == P_STEPS and all(math.isfinite(r["loss"]) for r in rows)
          and watch.params_equal == [True] * P_STEPS
          and watch.election_equal == [True] * P_STEPS and watch.voters == P_VOTERS
          and len(watch.hist) == P_STEPS
          and all(h[0] == h[1] and h[2] == h[3] for h in watch.hist)
          and record["drift"] == [0] * P_STEPS and record["skew"] == [0] * P_STEPS
          and all(b == everyone[0] for b in everyone) and lifecycle == P_LIFECYCLE
          and heal.equal == ([True] if rank == 1 else []) and len(heal.seconds) == 1
          and record["final"] == ["healthy"] * W4
          and bool(torch.isfinite(trainer.state.exp_avg).all()))
    if not ok:
        raise AssertionError(f"run (p) rank {rank}: {record}; boundaries equal on every rank "
                             f"{[b == everyone[0] for b in everyone]}")
    del trainer
    torch.cuda.empty_cache()
    return record


def plane_report(tmp: str, rec: dict, card: str) -> None:
    """Run (p)'s journals, after the spawn: every file strict JSON with the
    record keys; ``run_analyze.analyze_dir`` with no schema error, each
    rank's attribution closing with coverage >= ``P_COVERAGE`` over the 8
    steps, and the membership timeline of the four journals exactly
    ``P_TIMELINE``; prints rank 0's record, the step times and each rank's
    buckets."""
    jdir = pathlib.Path(tmp) / P_JOURNAL
    files = sorted(jdir.glob("journal_rank*.jsonl"))
    for f in files:
        for line in f.read_text().splitlines():
            if not {"kind", "name", "t", "rank"} <= set(strict_json(line)):
                raise AssertionError(f"run (p): {f.name} holds a record without its keys: {line}")
    report = run_analyze.analyze_dir(str(jdir))
    timeline = [(r.get("transition") or r["event"], r["step"], r.get("worker"))
                for r in report["membership"]]
    atts = [run_analyze.analyze_dir(str(jdir), rank=r)["attribution"] for r in range(W4)]
    if (len(files) != W4 or report["schema_errors"] or report["ranks"] != list(range(W4))
            or timeline != P_TIMELINE
            or not all(a["closes"] and a["coverage"] >= P_COVERAGE and a["steps"] == P_STEPS
                       for a in atts)):
        raise AssertionError(f"run (p): journals {[f.name for f in files]}, schema errors "
                             f"{report['schema_errors']}, timeline {timeline}, attribution "
                             f"{atts}")
    print(f"[w4] (p) control plane + journal: {W4_GPT2}, {W4} ranks on one card (gloo), "
          f"sign_psum, --telemetry, {P_SPEC}, --rejoin_probe_steps 2: losses "
          f"{[round(x, 4) for x in rec['losses']]}; every step's election == the plain election "
          f"of the gathered ballots under its mask {rec['election_equal']}, voters "
          f"{rec['voters']}; margin histogram and disagreement == bucket_vote_stats_plain at "
          f"every step (e.g. step 3 {rec['hist'][2][0]} dis {rec['hist'][2][2]}); rank 1's "
          f"lifecycle at the membership boundaries {rec['lifecycle']['_apply_membership']}, at "
          f"the guard folds {rec['lifecycle']['_apply_guard']}, the four ranks' equal; rank 1's "
          f"healed momentum == the healthy mean of ranks 0, 2, 3 (rank order); heal "
          f"{rec['heal_s'][0]:.3f} s; comm_drift_bytes {rec['drift']}, host_step_skew "
          f"{rec['skew']}, measured bytes a step {rec['measured'][0]}; step ms {rec['step_ms']} "
          f"(the heal lands in step 6; the check's gather of the four momenta is in it too); "
          f"run_clm.main {rec['wall_s']:.1f} s on {card}; rank 0 launches {rec['launches']}",
          flush=True)
    print(f"[journal] (p) membership timeline {timeline}; cross-rank step skew "
          f"{report['step_skew']}", flush=True)
    for r, a in enumerate(atts):
        print(f"[journal] (p) rank {r}: wall {a['wall_s']:.3f} s over {a['steps']} steps, "
              f"coverage {a['coverage']:.4f} ({'closes' if a['closes'] else 'DOES NOT CLOSE'}); "
              + ", ".join(f"{b} {v['s']:.3f} s ({v['frac']:.4f})" for b, v in a["buckets"].items())
              + f", other {a['other_s']:.3f} s, unattributed {a['unattributed_s']:.3f} s",
              flush=True)
    stalls = run_analyze.analyze_dir(str(jdir), rank=1)["top_stalls"]
    print("[journal] (p) rank 1 top spans: " + "; ".join(
        f"{s['name']} {s['s']:.3f} s x{s['count']}" for s in stalls), flush=True)


def sync_calls(trainer, blocks) -> tuple[dict, float]:
    """One more training step of ``trainer`` under ``torch.profiler`` (host
    and device activity): the counts of synchronizing CUDA runtime calls
    (``SYNC_CALLS``) and of device-to-host copies, and the step's wall ms
    (profiled)."""
    from torch.profiler import ProfilerActivity, profile
    trainer.cfg.max_steps = trainer.step_count + 1
    it = batch_iterator(blocks, trainer.global_train_batch(), seed=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(it)
        ms = 1e3 * (time.perf_counter() - t0)
    counts = dict.fromkeys(SYNC_CALLS + ("Memcpy DtoH",), 0)
    for e in prof.events():
        if e.name in SYNC_CALLS:
            counts[e.name] += 1
        elif e.device_type == torch.autograd.DeviceType.CUDA and "DtoH" in e.name:
            counts["Memcpy DtoH"] += 1
    return counts, ms


def journal_run(tmp: str, plain, plain_rows: list, plain_launches: dict, card: str) -> None:
    """Run (c-journal): (c)'s setup with ``--journal``. Its losses and final
    params' sha256 must equal (c)'s and its launches too; then one more
    profiled step of each (c)'s trainer and this one (its journal reopened
    on the same directory): the counts of synchronizing CUDA runtime calls
    and device-to-host copies must be equal (the journal adds no sync).
    Prints both runs' step times and the journal's attribution."""
    jdir = f"{tmp}/c_journal"
    jtr, rows, launches = run_counted(["--dropout", "0", "--journal", "--journal_dir", jdir])
    expect("(c-journal)", launches, plain_launches)
    same = ([r["loss"] for r in rows] == [r["loss"] for r in plain_rows]
            and params_sha(jtr) == params_sha(plain))
    report = run_analyze.analyze_dir(jdir)
    blocks, _ = run_clm.load_blocks(run_clm.DataArguments(synthetic_blocks=400),
                                    plain.cfg.block_size, plain.model.cfg.vocab_size)
    counts = {"off": sync_calls(plain, blocks)}
    jtr.journal = journal.Journal(jdir, rank=0)
    journal.install(jtr.journal)
    try:
        counts["on"] = sync_calls(jtr, blocks)
    finally:
        journal.uninstall(jtr.journal)
        jtr.journal.close()
    att = report["attribution"]
    if (not same or counts["on"][0] != counts["off"][0] or report["schema_errors"]
            or not att["closes"]):
        raise AssertionError(f"run (c-journal): losses and params equal to (c) {same}, sync "
                             f"calls on {counts['on'][0]} off {counts['off'][0]}, report {report}")
    recorded = sum(counts["off"][0].values()) > 0
    print(f"[journal] (c-journal) GPT-2 124M, 1 rank, --dropout 0 --journal: losses "
          f"{[round(r['loss'], 4) for r in rows]} and final params' sha256 {params_sha(jtr)[:16]}"
          f"... == (c)'s; launches == (c)'s; steps 2-{STEPS} "
          f"{[r['step_ms'] for r in rows[1:]]} ms against (c)'s "
          f"{[r['step_ms'] for r in plain_rows[1:]]} ms; one more profiled step: journal on "
          f"{counts['on'][1]:.1f} ms, off {counts['off'][1]:.1f} ms; synchronizing calls and "
          f"device-to-host copies on {counts['on'][0]} == off {counts['off'][0]}"
          + ("" if recorded else " (the profiler recorded no runtime call: not measured)")
          + f"; on {card}", flush=True)
    print(f"[journal] (c-journal) attribution over {att['steps']} steps: wall {att['wall_s']:.3f} "
          f"s, coverage {att['coverage']:.4f} ({'closes' if att['closes'] else 'DOES NOT CLOSE'}); "
          + ", ".join(f"{b} {v['s']:.3f} s ({v['frac']:.4f})" for b, v in att["buckets"].items())
          + f"; top spans: " + "; ".join(f"{s['name']} {s['s']:.3f} s x{s['count']}"
                                        for s in report["top_stalls"][:5]), flush=True)
    del jtr
    torch.cuda.empty_cache()


def w4_rank(rank: int, tmp: str) -> None:
    """One of run (f)'s ranks: every W4_RUNS entry through ``run_clm.main``
    on cuda:0 in the gloo group, under a :class:`StepWatch`, GPT-2 at
    W4_LAYERS blocks; raises on a failed check; rank 0 writes the runs'
    records to ``tmp/w4.json``."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg4", rank=rank, world_size=W4)
    try:
        with gpt2_cut(W4_LAYERS):   # every GPT-2 run of this spawn
            records = []
            for wire, extra, steps in W4_RUNS:
                label = wire + (" " + " ".join(extra) if extra else "")
                watch, events = StepWatch(), GuardEvents()
                reset_counts()
                t0 = time.perf_counter()
                try:
                    trainer = run_clm.main(W4_ARGS + ["--wire", wire, "--max_steps", str(steps)]
                                           + extra)
                finally:
                    watch.close()
                    events.close()
                wall = time.perf_counter() - t0
                launches = read_counts()
                rows = [r for r in trainer.history if "loss" in r]
                cfg = trainer.cfg
                lazy = cfg.vote_every > 1
                buckets = len(bucket_bounds(vote_chunk_elems(trainer.n_params, cfg.vote_every)
                                            if lazy else trainer.n_params,
                                            cfg.vote_buckets, W4, cfg.wire))
                stochastic = cfg.max_grad_norm is not None
                expect(f"(f) {label} rank {rank}", launches,
                       dict(optimizer_launches(trainer, steps),
                            **flash_launches(steps, accum=1, eval_batches=0,
                                             layers=W4_LAYERS)))
                bits = lazy_checks(f"run (f) {label} rank {rank}", trainer, watch, steps) \
                    if lazy else None
                if (trainer.world != W4 or cfg.wire != wire or len(rows) != steps
                        or not all(math.isfinite(r["loss"]) for r in rows)
                        or watch.params_equal != [True] * steps
                        or (not stochastic and not lazy and not watch.election_equal)
                        or not all(watch.election_equal)
                        or any(h[0] != h[1] or h[2] != h[3] for h in watch.hist)
                        or (stochastic and not rows[0]["vote/stoch_flip_frac"] > 0)):
                    raise AssertionError(
                        f"run (f) {label} rank {rank}: world {trainer.world}, wire {cfg.wire}, "
                        f"rows {rows}, params equal after each step {watch.params_equal}, "
                        f"election == plain {watch.election_equal}, histogram and disagreement "
                        f"(frame, plain) {watch.hist}")
                guard = guard_checks(label, rank, trainer, watch, events.events, rows, extra)
                records.append({"run": label, "buckets": buckets, "wall_s": wall, "guard": guard,
                                "params_sha256": params_sha(trainer),
                                "losses": [r["loss"] for r in rows],
                                "step_ms": [r["step_ms"] for r in rows],
                                "params_equal": watch.params_equal,
                                "election_equal": watch.election_equal, "hist": watch.hist,
                                "slices_equal": watch.slices_equal, "bits_per_param": bits,
                                "comm_stats": trainer.comm_stats(),
                                "stoch_flip_frac": [r["vote/stoch_flip_frac"] for r in rows],
                                "launches": launches})
                del trainer
                torch.cuda.empty_cache()
            records.append(q_run(rank))
            records.append(r_run(rank))
            records.append(tp_runs(rank))
            records.append(sp_runs(rank))
            records.append(plane_run(rank, tmp))
            records.append(w4_async_commit(rank, tmp))
            if rank == 0:
                with open(f"{tmp}/w4.json", "w") as f:
                    json.dump(records, f)
    finally:
        dist.destroy_process_group()


class GuardEvents:
    """Records the vote guard's transitions, ``[step, quarantined,
    readmitted]``, while installed (``VoteGuard.update`` wrapped)."""

    def __init__(self):
        self.events: list = []
        self._orig = vote_guard.VoteGuard.update
        watch = self

        def update(guard, step, obs, advanced):
            ev = watch._orig(guard, step, obs, advanced)
            if ev.quarantined or ev.readmitted:
                watch.events.append([int(step), [int(w) for w in ev.quarantined],
                                     [int(w) for w in ev.readmitted]])
            return ev

        vote_guard.VoteGuard.update = update

    def close(self) -> None:
        vote_guard.VoteGuard.update = self._orig


def guard_checks(label: str, rank: int, trainer, watch, events: list, rows: list,
                 extra: list) -> Optional[dict]:
    """Run (m)'s checks on one W4 run with ``--vote_guard enforce``; None for
    the other runs. (m1), every rank healthy: no transition, the mask all
    healthy. (m2), rank 1's grads NaN: the transitions ``M2_EVENTS``,
    momentum finite on every rank (enforce zeroes the NaN grads before the
    momentum update), the sentinel silent (it would have raised), the mask
    and the strikes in every logged row. (m3), rank 2 inverted: quarantined,
    and at least one step voted, and was held to the plain election and
    ``bucket_vote_stats_plain``, on the masked tally."""
    if trainer.cfg.vote_guard != "enforce":
        return None
    health = trainer.state.health.tolist()
    out = {"events": events, "health": health, "masked": watch.masked,
           "rows": [[r["guard_healthy_mask"], r["guard_strikes"]] for r in rows],
           "momentum_finite": bool(torch.isfinite(trainer.state.exp_avg).all())}
    if M2_POISON in extra:
        ok = events == M2_EVENTS and out["momentum_finite"] and health == [1, 0, 1, 1]
    elif "flipped_ballot:2" in extra:
        ok = health == [1, 1, 0, 1] and any(watch.masked) and len(watch.hist) == len(rows)
    else:
        ok = not events and all(health)
    if not ok:
        raise AssertionError(f"run (m) {label} rank {rank}: guard record {out}")
    return out


def w4_async_commit(rank: int, tmp: str) -> dict:
    """An async checkpoint at W4 on the card: every rank saves its CUDA
    tensor as step 1, and the commit thread (its own gloo group) commits
    it with no later save and no ``close()``: ``COMMITTED`` appears within
    COMMIT_POLL_S and the step verifies."""
    ck = Checkpointer(f"{tmp}/ck4", async_save=True, group=dist.group.WORLD)
    t0 = time.monotonic()
    ck.save(1, {f"exp_avg/rank{rank:05d}.pt": torch.full((1 << 20,), float(rank),
                                                         device="cuda")})
    marker = ck.directory / "1" / resilience.MARKER
    while not marker.exists() and time.monotonic() - t0 < COMMIT_POLL_S:
        time.sleep(0.01)
    seconds = time.monotonic() - t0
    dist.barrier()   # every rank has looked before any closes
    committed, valid = marker.exists(), ck.latest_valid_step()
    ck.close()
    if not committed or valid != 1:
        raise AssertionError(f"run (f) rank {rank}: an async save at W = {W4} left COMMITTED "
                             f"{committed}, latest_valid_step {valid} after {seconds:.2f} s")
    return {"run": "async commit", "seconds": seconds}


def w4_phase(tmp: str, card: str) -> None:
    """Run (f): W4 processes on cuda:0 in a gloo group (NCCL refuses two
    ranks on one device); prints rank 0's record of each run."""
    mp.spawn(w4_rank, args=(tmp,), nprocs=W4, join=True)
    with open(f"{tmp}/w4.json") as f:
        records = json.load(f)
    commit = records.pop()
    plane_report(tmp, records.pop(), card)
    sp_report(records.pop(), card)
    tp_report(records.pop(), card)
    r_report(records.pop(), card)
    q_report(records.pop(), card)
    print(f"[w4] (f) async checkpoint at W = {W4}: step 1 COMMITTED by the commit thread "
          f"{commit['seconds']:.3f} s after save() on rank 0, with no later save and no close(); "
          f"latest_valid_step() == 1 on every rank; on {card}", flush=True)
    by_run = {rec["run"]: rec for rec in records}
    m1 = by_run["packed_a2a --vote_guard enforce"]
    if m1["params_sha256"] != by_run["packed_a2a"]["params_sha256"]:
        raise AssertionError(f"run (m1): the final params' sha256 {m1['params_sha256']} differs "
                             f"from (f) packed_a2a's {by_run['packed_a2a']['params_sha256']}")
    for rec in records:
        hist = ("" if not rec["hist"] else
                f"; margin histogram {rec['hist'][0][0]} == bucket_vote_stats_plain of the "
                f"gathered tally, disagreement {rec['hist'][0][2]} == {rec['hist'][0][3]}"
                + (f" (and at each of the {len(rec['hist'])} steps, the tally masked at steps "
                   f"{[i + 1 for i, m in enumerate(rec['guard']['masked']) if m]})"
                   if rec["guard"] else ""))
        guard = ""
        if rec["guard"]:
            g = rec["guard"]
            guard = (f"; guard: params sha256 {rec['params_sha256'][:16]}..., transitions "
                     f"[step, quarantined, readmitted] {g['events']}, final mask {g['health']}, "
                     f"momentum finite on every rank {g['momentum_finite']}, logged masks "
                     f"{[r[0] for r in g['rows']]}, strikes {[r[1] for r in g['rows']]}")
            if rec is m1:
                guard += " == (f) packed_a2a's sha256 (enforce with every rank healthy)"
        if rec["bits_per_param"] is not None:
            election = (f"every step's slice election == the plain election of the 4 gathered "
                        f"slice ballots {rec['slices_equal']}, the cache after step "
                        f"{LAZY_STEPS} == a plain re-election of every slot, slots 1-3 decayed "
                        f"only at step 1; WireTally == wire_bytes_per_param every step: "
                        f"{rec['bits_per_param']:.4f} bits/param/step (comm_stats "
                        f"{rec['comm_stats']['comm_bits_per_param']:.4f})")
        elif rec["guard"]:
            election = (f"every step's election == the plain election of the 4 gathered "
                        f"ballots under the step's health mask {rec['election_equal']}")
        elif rec["election_equal"]:
            election = "step-1 election == the plain election of the 4 gathered ballots"
        else:
            election = f"stochastic: stoch_flip_frac {rec['stoch_flip_frac']}"
        print(f"[w4] {'(m)' if rec['guard'] else '(f)'} {rec['run']}: {W4_GPT2}, {W4} ranks on "
              f"one card (gloo), B 2 x accum 1 x T 1024, {rec['buckets']} bucket(s): losses "
              f"{[round(x, 4) for x in rec['losses']]}; params equal on all ranks after each "
              f"step {rec['params_equal']}; {election}{hist}{guard}; step ms {rec['step_ms']} "
              f"(4 ranks "
              f"share the card and gloo stages every collective through the host); run_clm.main "
              f"{rec['wall_s']:.1f} s on {card}; rank 0 launches {rec['launches']}", flush=True)


# run (g), resume on the card: GPT-2 124M at full width on a bin: shard the
# port's GPT-2 BPE makes from the repo's own text, through the native loader
G_STEPS = 4
G_SPLIT = 2   # the interrupted run saves here; a fresh process resumes to G_STEPS
G_EVAL = 1    # eval batches: --eval_iters 1
G_ARGS = ["--model_name", "gpt2_124m", "--lion", "--async_grad", "--wire", "auto",
          "--per_device_train_batch_size", "8", "--gradient_accumulation_steps", str(ACCUM),
          "--block_size", "1024", "--logging_steps", "1", "--dropout", "0", "--telemetry",
          "--save_steps", str(G_SPLIT), "--per_device_eval_batch_size", "4",
          "--eval_iters", str(G_EVAL)]
G_STOCH = ["--max_grad_norm", "1.0"]
O_SIGTERM_AT = 3   # run (o): the stochastic resume's process gets SIGTERM at this batch
ROOT = pathlib.Path(__file__).resolve().parent


def make_shard(tmp: str, card: str) -> tuple[str, int, float]:
    """The repo's ``*.md`` files, each a document ending in EOS, through the
    port's GPT-2 BPE (``runs/parity/tok``) with its C++ merge core, written
    as a uint16 ``bin:`` shard; returns (path, tokens, host tokens/s of the
    encode)."""
    tok = BPETokenizer.load(str(ROOT / "runs" / "parity" / "tok"))
    if not tok.native:
        raise AssertionError("run (g): the BPE tokenizer did not build its C++ merge core")
    texts = [p.read_text(encoding="utf-8", errors="replace") for p in sorted(ROOT.glob("*.md"))]
    t0 = time.perf_counter()
    ids = [i for text in texts for i in tok.encode(text, add_eos=True)]
    dt = time.perf_counter() - t0
    path = f"{tmp}/g_shard.bin"
    np.asarray(ids, np.uint16).tofile(path)
    print(f"[resume] shard: {len(texts)} *.md files, {sum(map(len, texts))} characters -> "
          f"{len(ids)} GPT-2 BPE tokens (vocabulary {tok.vocab_size}), native core "
          f"{len(ids) / dt:.0f} tokens/s on the host of {card}", flush=True)
    return path, len(ids), len(ids) / dt


def g_expect(steps: int, stochastic: bool, evals: int = G_EVAL) -> dict:
    """Run (g)'s launches for ``steps`` steps and ``evals`` eval batches."""
    fused = 0 if stochastic else steps
    return {"fused_ballots": fused, "fused_apply": fused, "bucket_vote_stats": steps,
            "flash_attention_fwd": N_LAYER * (ACCUM * 2 * steps + evals),
            "flash_attention_bwd_dkv": N_LAYER * ACCUM * steps,
            "flash_attention_bwd_dq": N_LAYER * ACCUM * steps,
            "flash_attention_di": N_LAYER * ACCUM * steps, **NO_HD128}


def g_rows(rows: list, steps: int, label: str) -> list:
    """The loss rows of a run (g) leg: ``steps`` finite losses, each batch
    served by the native loader (its ``skipped_shards`` counter rides the
    row, 0)."""
    rows = [r for r in rows if "loss" in r]
    if (len(rows) != steps or not all(math.isfinite(r["loss"]) for r in rows)
            or any(r.get("skipped_shards") != 0 for r in rows)):
        raise AssertionError(f"run (g) {label}: expected {steps} finite losses from the native "
                             f"loader, got {rows}")
    return rows


def g_run(shard: str, out: str, steps: int, extra: list, label: str):
    """One in-process ``run_clm.main`` of run (g), counted; returns (final
    state on the host, rows, launches, checkpointer)."""
    reset_counts()
    trainer = run_clm.main(G_ARGS + ["--dataset", f"bin:{shard}", "--max_steps", str(steps),
                                     "--output_dir", out] + extra)
    launches = read_counts()
    expect(f"(g) {label}", launches, g_expect(steps, bool(extra and G_STOCH[0] in extra)))
    state = {"params": trainer.flat.params.cpu(), "exp_avg": trainer.state.exp_avg.cpu(),
             "vote_health": {f.name: getattr(trainer.vote_health, f.name).cpu()
                             for f in dataclasses.fields(trainer.vote_health)}}
    rows = g_rows(trainer.history, steps, label)
    ck = trainer.checkpointer
    del trainer
    torch.cuda.empty_cache()
    return state, rows, launches, ck


class SigtermAt:
    """Run (o): forwards the native loader's iterator and sends this
    process SIGTERM while it fetches global batch ``at`` (1-based, the
    batches a resume skips counted)."""

    def __init__(self, inner, at: int):
        self.inner, self.at, self.n = inner, at, 0

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        if self.n == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return next(self.inner)

    def skip(self, k: int) -> None:
        self.n += k
        self.inner.skip(k)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def resume_child(tmp: str, out_json: str, sigterm_at: int, argv: list) -> int:
    """The resumed leg of run (g), in a fresh process: ``run_clm.main(argv)``
    in a 1-rank NCCL group, every counter at 0 before it, with a SIGTERM at
    global batch ``sigterm_at`` when it is not 0 (run (o)); writes the
    launches, the rows, the resume time, the step it stopped at, whether a
    preemption stopped it and the process wall to ``out_json``."""
    if sigterm_at:
        pipeline = run_clm.make_native_pipeline

        def signalling(*args, **kw):
            native = pipeline(*args, **kw)
            return native if native is None else (SigtermAt(native[0], sigterm_at),
                                                  *native[1:])

        run_clm.make_native_pipeline = signalling
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg_child", rank=0, world_size=1)
    try:
        reset_counts()
        trainer = run_clm.main(argv)
        launches = read_counts()
        with open(out_json, "w") as f:
            json.dump({"launches": launches, "rows": trainer.history,
                       "resume_s": trainer.resume_s, "start_step": trainer.history[0]["step"] - 1,
                       "step": trainer.step_count, "preempted": trainer.preempted,
                       "wall_s": time.perf_counter() - t0}, f)
    finally:
        dist.destroy_process_group()
    return 0


def g_child(tmp: str, shard: str, out: str, extra: list, label: str, start: int,
            sigterm_at: int = 0) -> tuple:
    """A fresh process resuming run (g) from step ``start`` in ``out`` to
    G_STEPS, or with ``sigterm_at`` (run (o)) until the preemption the
    SIGTERM at that batch triggers: it must exit 0, stopped at that step
    with a committed checkpoint tagged ``preempt`` and no eval. Returns the
    child's record, its stdout and the process wall."""
    out_json = f"{tmp}/g_child.json"
    argv = G_ARGS + ["--dataset", f"bin:{shard}", "--max_steps", str(G_STEPS),
                     "--output_dir", out] + extra
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--resume-child", tmp, out_json,
                           str(sigterm_at), *argv], capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"run (g) {label}: the resumed process exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(out_json) as f:
        child = json.load(f)
    if child["start_step"] != start or f"resumed from checkpoint step {start}" not in proc.stdout:
        raise AssertionError(f"run (g) {label}: the fresh process did not resume from step "
                             f"{start}:\n{proc.stdout[-3000:]}")
    stop = sigterm_at or G_STEPS
    if child["step"] != stop or child["preempted"] != bool(sigterm_at):
        raise AssertionError(f"run (g) {label}: stopped at step {child['step']} (preempted "
                             f"{child['preempted']}), expected {stop}:\n{proc.stdout[-3000:]}")
    if sigterm_at:
        sdir = f"{out}/checkpoints/{stop}"
        manifest = resilience.read_manifest(sdir) or {}
        if (not resilience.verify_step_dir(sdir) or manifest.get("meta", {}).get("tag") != "preempt"
                or "[run_clm] preempted: checkpoint durable, exiting cleanly" not in proc.stdout):
            raise AssertionError(f"run (o) {label}: step {stop} is not a committed 'preempt' "
                                 f"checkpoint (meta {manifest.get('meta')}):\n"
                                 f"{proc.stdout[-3000:]}")
    expect(f"(g) {label}, resumed from {start}", child["launches"],
           g_expect(stop - start, G_STOCH[0] in extra, evals=0 if sigterm_at else G_EVAL))
    return child, proc.stdout, wall


def g_resumed(tmp: str, shard: str, out: str, extra: list, label: str,
              preempt_at: int = 0) -> dict:
    """Run (g)'s interrupted leg: G_SPLIT steps in this process, then a
    fresh process resumes from ``out`` to G_STEPS; with ``preempt_at``
    (run (o)) that process is preempted at that step and a second one
    resumes from its checkpoint. Returns the record with the loss rows of
    every leg and the resumed step's files."""
    _, rows, _, _ = g_run(shard, out, G_SPLIT, extra, f"{label}, steps 1-{G_SPLIT}")
    start, preempted = G_SPLIT, None
    if preempt_at:
        child, _, wall = g_child(tmp, shard, out, extra, f"{label}, preempted", start,
                                 sigterm_at=preempt_at)
        rows = rows + g_rows(child["rows"], preempt_at - start, f"{label}, preempted")
        preempted, start = {"child": child, "process_wall_s": wall}, preempt_at
    child, _, wall = g_child(tmp, shard, out, extra, label, start)
    rows = rows + g_rows(child["rows"], G_STEPS - start, f"{label}, resumed")
    ck = f"{out}/checkpoints"
    vh = torch.load(f"{ck}/{G_STEPS}/vote_health.pt", weights_only=True)
    return {"rows": rows, "child": child, "process_wall_s": wall, "preempted": preempted,
            "params": torch.load(f"{ck}/{G_STEPS}/params.pt", weights_only=True)["flat"],
            "exp_avg": torch.load(f"{ck}/{G_STEPS}/exp_avg/rank00000.pt", weights_only=True),
            "vote_health": vh}


def g_equal(label: str, want: dict, want_rows: list, got: dict, got_rows: list) -> None:
    """``torch.equal`` of losses, params, momentum and every vote-health
    counter."""
    losses = [r["loss"] for r in want_rows], [r["loss"] for r in got_rows]
    differ = [k for k in ("params", "exp_avg") if not torch.equal(want[k], got[k])]
    differ += [f"vote_health.{k}" for k, v in want["vote_health"].items()
               if not torch.equal(v, got["vote_health"][k])]
    if losses[0] != losses[1]:
        differ.append(f"losses {losses}")
    if differ:
        raise AssertionError(f"run (g) {label}: not torch.equal in {differ}")
    print(f"[resume] {label}: torch.equal in the losses {[round(x, 6) for x in losses[0]]}, "
          f"params, momentum and every vote-health counter", flush=True)


def resume_phase(tmp: str, card: str) -> None:
    """Run (g): two uninterrupted 4-step runs (async and synchronous
    saves) equal; then 2 steps, a fresh process resuming to 4, equal to
    them; the same for the stochastic mode; then the committed step
    verified, torn, and autodetect falling back to the step before."""
    t = time.perf_counter()
    shard, n_tokens, tok_s = make_shard(tmp, card)
    a, a_rows, a_launches, a_ck = g_run(shard, f"{tmp}/g_a", G_STEPS, [], "async saves")
    b, b_rows, _, b_ck = g_run(shard, f"{tmp}/g_b", G_STEPS, ["--async_ckpt", "false"],
                               "synchronous saves")
    g_equal("uninterrupted twice (async saves against synchronous)", a, a_rows, b, b_rows)
    step_dir = pathlib.Path(f"{tmp}/g_a/checkpoints/{G_STEPS}")
    ckpt_bytes = sum(p.stat().st_size for p in step_dir.rglob("*") if p.is_file())
    if not resilience.verify_step_dir(step_dir):
        raise AssertionError(f"run (g): {step_dir} does not verify")
    stall = {k: ([r["ckpt_stall_s"] for r in rows], ck.total_stall_s)
             for k, rows, ck in (("async", a_rows, a_ck), ("sync", b_rows, b_ck))}
    print(f"[resume] checkpoint of step {G_STEPS}: {ckpt_bytes} bytes in "
          f"{len([p for p in step_dir.rglob('*') if p.is_file()])} files; commit (manifest "
          f"digest + marker) {a_ck.last_commit_s:.3f} s; ckpt_stall_s by row, async "
          f"{stall['async'][0]} (total with the close's drain {stall['async'][1]:.3f} s), "
          f"synchronous {stall['sync'][0]} (total {stall['sync'][1]:.3f} s); data wait "
          f"{[round(r['data_wait_ms'], 3) for r in a_rows]} ms a step (native loader); "
          f"on {card}", flush=True)
    shutil.rmtree(f"{tmp}/g_b")
    r = g_resumed(tmp, shard, f"{tmp}/g_c", [], "deterministic")
    g_equal("2 steps + a fresh process resuming to 4, against uninterrupted", a, a_rows, r,
            r["rows"])
    print(f"[resume] resumed process: verify + restore {r['child']['resume_s']:.3f} s, process "
          f"{r['process_wall_s']:.1f} s (its own clock {r['child']['wall_s']:.1f} s); launches "
          f"{r['child']['launches']}; on {card}", flush=True)
    ck_c = f"{tmp}/g_c/checkpoints"
    if not (resilience.verify_step_dir(f"{ck_c}/{G_STEPS}")
            and resilience.latest_valid_step_in(ck_c) == G_STEPS):
        raise AssertionError(f"run (g): the resumed run's step {G_STEPS} does not verify")
    torn = resilience.tear_leaf_file(ck_c, G_STEPS)
    fallback = Checkpointer(ck_c).latest_valid_step()
    if (resilience.verify_step_dir(f"{ck_c}/{G_STEPS}") or fallback != G_SPLIT
            or resilience.latest_valid_step_in(ck_c) != G_SPLIT):
        raise AssertionError(f"run (g): after tearing {torn} autodetect found {fallback}, "
                             f"expected {G_SPLIT}")
    print(f"[resume] tore {torn.relative_to(ck_c)} of step {G_STEPS}: it no longer verifies, "
          f"autodetect falls back to step {fallback}", flush=True)
    for d in ("g_a", "g_c"):
        shutil.rmtree(f"{tmp}/{d}")
    del a, b, r
    s, s_rows, _, _ = g_run(shard, f"{tmp}/g_d", G_STEPS, G_STOCH, "stochastic")
    t_o = time.perf_counter()
    rs = g_resumed(tmp, shard, f"{tmp}/g_e", G_STOCH, "stochastic", preempt_at=O_SIGTERM_AT)
    g_equal(f"stochastic (--max_grad_norm 1.0): 2 steps + a fresh process preempted at step "
            f"{O_SIGTERM_AT} (run (o)) + a fresh process resuming to 4, against uninterrupted",
            s, s_rows, rs, rs["rows"])
    pre = rs["preempted"]
    print(f"[resume] (o) --on_preempt save_exit (the default): SIGTERM at batch "
          f"{O_SIGTERM_AT} of the resumed process; it exited 0 at step {O_SIGTERM_AT} with a "
          f"committed 'preempt' checkpoint (no eval, no final save), process "
          f"{pre['process_wall_s']:.1f} s, launches {pre['child']['launches']}; the next process "
          f"resumed from it to step {G_STEPS}; the three legs "
          f"{time.perf_counter() - t_o:.1f} s on {card}", flush=True)
    for d in ("g_d", "g_e"):
        shutil.rmtree(f"{tmp}/{d}")
    print(f"[slice] (g) resume: GPT-2 124M, 1 rank, B 8 x accum {ACCUM} x T 1024 on "
          f"{n_tokens} tokens of the repo's text (bin:, native loader), losses "
          f"{[round(x['loss'], 4) for x in a_rows]}; steps 2-{G_STEPS} "
          f"{[x['step_ms'] for x in a_rows[1:]]} ms; native BPE {tok_s:.0f} tokens/s; "
          f"launches of the uninterrupted run {a_launches}; on {card}", flush=True)
    phase_time("slice (g), resume on the card", t)


LAZY_ARGS = ["--dropout", "0", "--telemetry", "--vote_every", str(LAZY_K),
             "--lr_scheduler_type", "constant"]   # run (h1): the sign steps are real from step 1
LAZY_STOCH_ARGS = LAZY_ARGS + ["--max_grad_norm", str(STOCH_MGN)]   # run (h3)
BF16_ARGS = ["--dropout", "0", "--telemetry", "--mom_dtype", "bfloat16"]   # run (h2)
ADAMW_ARGS = ["--dropout", "0", "--lion", "false", "--async_grad", "false"]   # run (i)


def modes_phase(gen, card) -> tuple[list, dict]:
    """Runs (h1), (h3), (h2) and (i) in the 1-rank NCCL group, then the
    optimizer steps' device times; returns the runs' (label, rows,
    launches) and the times."""
    t = time.perf_counter()
    watch = StepWatch()
    try:
        lazy, lazy_rows, lazy_launches = run_counted(LAZY_ARGS, LAZY_STEPS)
    finally:
        watch.close()
    expect("(h1) vote_every 4", lazy_launches,
           dict(optimizer_launches(lazy, LAZY_STEPS), **flash_launches(LAZY_STEPS)))
    lazy_checks("run (h1)", lazy, watch, LAZY_STEPS)
    print(f"[modes] (h1) --vote_every {LAZY_K}: GPT-2 124M, 1 rank, B 8 x accum {ACCUM}, "
          f"{LAZY_STEPS} steps: losses {[round(r['loss'], 4) for r in lazy_rows]}; every step's "
          f"slice election == the plain election {watch.slices_equal}; the cache after step "
          f"{LAZY_STEPS} == a plain re-election of every slot ({lazy.state.elected.numel()} "
          f"bytes); at step 1 slots 1-3 decayed only, slot 0 all moved; valid_frac by step "
          f"{[r['vote/valid_frac'] for r in lazy_rows]}; step ms "
          f"{[r['step_ms'] for r in lazy_rows]}; launches {lazy_launches}", flush=True)
    del lazy
    torch.cuda.empty_cache()
    t = phase_time("slice (h1), GPT-2 124M vote_every 4", t)
    watch = StepWatch()
    try:
        lzs, lzs_rows, lzs_launches = run_counted(LAZY_STOCH_ARGS, LAZY_STEPS)
    finally:
        watch.close()
    expect("(h3) vote_every 4 + max_grad_norm", lzs_launches,
           dict(optimizer_launches(lzs, LAZY_STEPS), **flash_launches(LAZY_STEPS)))
    lazy_checks("run (h3)", lzs, watch, LAZY_STEPS)
    flips = [r["vote/stoch_flip_frac"] for r in lzs_rows]
    if not all(0.0 < f < 1.0 for f in flips):
        raise AssertionError(f"run (h3): vote/stoch_flip_frac {flips}, expected each in (0, 1)")
    print(f"[modes] (h3) --vote_every {LAZY_K} --max_grad_norm {STOCH_MGN}: GPT-2 124M, 1 rank, "
          f"B 8 x accum {ACCUM}, {LAZY_STEPS} steps: losses "
          f"{[round(r['loss'], 4) for r in lzs_rows]}; every step's slice election == the plain "
          f"election of the ballots replayed from (seed, count, rank) {watch.slices_equal}; the "
          f"cache after step {LAZY_STEPS} == a plain re-election of every slot's replayed "
          f"ballots; stoch_flip_frac by step {flips}; step ms {[r['step_ms'] for r in lzs_rows]}; "
          f"launches {lzs_launches}", flush=True)
    del lzs
    torch.cuda.empty_cache()
    t = phase_time("slice (h3), GPT-2 124M vote_every 4 + max_grad_norm", t)
    bf16, bf16_rows, bf16_launches = run_counted(BF16_ARGS)
    expect("(h2) mom_dtype bfloat16", bf16_launches,
           dict(optimizer_launches(bf16, STEPS), **flash_launches(STEPS)))
    m = bf16.state.exp_avg
    if m.dtype != torch.bfloat16 or bf16.flat.params.dtype != torch.float32:
        raise AssertionError(f"run (h2): momentum {m.dtype}, params {bf16.flat.params.dtype}")
    print(f"[modes] (h2) --mom_dtype bfloat16: losses {[round(r['loss'], 4) for r in bf16_rows]}; "
          f"momentum {m.dtype}, {m.numel() * m.element_size()} bytes a rank (float32: "
          f"{m.numel() * 4}); step ms {[r['step_ms'] for r in bf16_rows]}; launches "
          f"{bf16_launches}", flush=True)
    del bf16, m
    torch.cuda.empty_cache()
    t = phase_time("slice (h2), GPT-2 124M mom_dtype bfloat16", t)
    adam, adam_rows, adam_launches = run_counted(ADAMW_ARGS)
    expect("(i) AdamW", adam_launches,
           dict(optimizer_launches(adam, STEPS), **flash_launches(STEPS)))
    print(f"[modes] (i) --lion false --async_grad false (AdamW): losses "
          f"{[round(r['loss'], 4) for r in adam_rows]}; step ms "
          f"{[r['step_ms'] for r in adam_rows]}; launches {adam_launches}", flush=True)
    del adam
    torch.cuda.empty_cache()
    t = phase_time("slice (i), GPT-2 124M AdamW", t)
    times = mode_step_times(gen)
    phase_time("optimizer modes' step times", t)
    return [("(h1) dropout 0 + telemetry + vote_every 4", lazy_rows, lazy_launches),
            ("(h3) dropout 0 + telemetry + vote_every 4 + max_grad_norm 1.0", lzs_rows,
             lzs_launches),
            ("(h2) dropout 0 + telemetry + mom_dtype bfloat16", bf16_rows, bf16_launches),
            ("(i) dropout 0, AdamW", adam_rows, adam_launches)], times


L2_LAYERS = 2   # run (l2): Llama-2-7B's width at 2 layers, a float32 merged write of 2.7 GB
L_VOCAB = 32_000   # Llama-2's vocabulary: the checkpoints' embedding rows
GPT2_VOCAB = 50_257


def peak_rss_bytes() -> int:
    """The process's peak resident host memory since it started
    (``getrusage``; Linux counts kilobytes)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class RssWatch:
    """Samples this process's resident host memory (``VmRSS`` in
    ``/proc/self/status``) every 5 ms on a thread while it is entered;
    ``base`` holds it at entry and ``peak`` its maximum, in bytes."""

    def __init__(self):
        self.base = self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def sample() -> int:
        for line in pathlib.Path("/proc/self/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
        raise AssertionError("/proc/self/status has no VmRSS line")

    def _run(self) -> None:
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self.sample())

    def __enter__(self) -> "RssWatch":
        self.base = self.peak = self.sample()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.sample())

    def text(self, what: str) -> str:
        return (f"host RSS {self.base / 2**30:.2f} GiB before {what}, peak "
                f"{self.peak / 2**30:.2f} during it (VmRSS sampled every 5 ms)")


def rss_text() -> str:
    return f"process peak host RSS {peak_rss_bytes() / 2**30:.2f} GiB (getrusage)"


def drop_cached(path: str) -> None:
    """Write ``path``'s files through and ask the kernel to drop them from
    its page cache, so that the import reads them from the disk."""
    for name in os.listdir(path):
        fd = os.open(os.path.join(path, name), os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def dir_bytes(path: str) -> int:
    """The bytes of the safetensors files under ``path``."""
    return sum(os.path.getsize(os.path.join(path, n)) for n in os.listdir(path)
               if n.endswith(".safetensors"))


def write_llama_checkpoint(path: str, cfg: LlamaConfig, seed: int, tokenizer: dict,
                           keep=()) -> tuple:
    """A seeded bfloat16 Llama (``llama_init``) written as Hugging Face
    publishes ``Llama-2-7b-hf`` (``config.json``, safetensors shards of at
    most 10 GB under ``model.safetensors.index.json``) with a
    ``tokenizer.json``, by the port's writer and name mapping; returns (the
    kept leaves ``{path: tensor}``, seconds to write)."""
    params = llama_init(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hf_export.llama_to_hf(params, cfg, path)
    pathlib.Path(path, "tokenizer.json").write_text(json.dumps(tokenizer), encoding="utf-8")
    drop_cached(path)
    seconds = time.perf_counter() - t0
    kept = {p: t for p, t in iter_paths(params) if p[0] in keep or p[:2] in keep}
    del params
    torch.cuda.empty_cache()
    return kept, seconds


class ImportTimer:
    """Wraps ``hf_import``'s importer ``name`` (and ``quantize_leaf``)
    while a CLI runs: the import's wall seconds, device synchronized, the
    seconds spent quantizing, and what it returned."""

    def __init__(self, name: str):
        self.name, self.seconds, self.quant_s, self.result = name, 0.0, 0.0, None
        self.rss = RssWatch()
        self._orig = getattr(hf_import, name)
        self._quant = hf_import.quantize_leaf

    def __enter__(self):
        def timed_import(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with self.rss:
                self.result = self._orig(*a, **k)
                torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return self.result

        def timed_quant(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._quant(*a, **k)
            torch.cuda.synchronize()
            self.quant_s += time.perf_counter() - t0
            return out

        setattr(hf_import, self.name, timed_import)
        hf_import.quantize_leaf = timed_quant
        return self

    def __exit__(self, *exc):
        setattr(hf_import, self.name, self._orig)
        hf_import.quantize_leaf = self._quant


def sp_model_from_bpe(bpe: BPETokenizer) -> bytes:
    """A Llama-shaped SentencePiece BPE model from GPT-2 BPE's vocabulary:
    ``<unk>``/``<s>``/``</s>``, the 256 byte-fallback pieces, every single
    character, then each merge whose text decodes, scored by its rank (``▁``
    for the space)."""
    u2b = unicode_to_bytes()

    def text(tok: str) -> Optional[str]:
        try:
            return bytes(u2b[c] for c in tok).decode("utf-8").replace(" ", "▁")
        except (KeyError, UnicodeDecodeError):
            return None

    pieces = [("<unk>", 0.0, spm._UNKNOWN), ("<s>", 0.0, spm._CONTROL),
              ("</s>", 0.0, spm._CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, spm._BYTE) for b in range(256)]
    seen = {p for p, _, _ in pieces}
    for c in sorted({c for tok in bpe.vocab for c in (text(tok) or "")} - seen):
        pieces.append((c, -1e6, spm._NORMAL))
        seen.add(c)
    for (a, b), rank in sorted(bpe.ranks.items(), key=lambda kv: kv[1]):
        t = text(a + b)
        if t and t not in seen:
            pieces.append((t, -float(rank), spm._NORMAL))
            seen.add(t)
    return spm.write_model_proto(pieces)


def tokenizer_check(card: str) -> dict:
    """``[tok]``: the ``tokenizer.json`` of ``runs/parity/tok`` encodes the
    repo's ``*.md`` to ``BPETokenizer``'s ids; host tokens/s of
    ``TokenizerJSON`` and of ``SentencePieceTokenizer`` on a model written
    by ``write_model_proto``. Returns the tokenizer.json spec."""
    bpe = BPETokenizer.load(str(ROOT / "runs" / "parity" / "tok"))
    spec = bpe_tokenizer_json(bpe)
    texts = [p.read_text(encoding="utf-8", errors="replace") for p in sorted(ROOT.glob("*.md"))]
    tj = TokenizerJSON(spec)
    rates = {}
    for name, tok in (("TokenizerJSON", tj),
                      ("SentencePieceTokenizer", spm.SentencePieceTokenizer(
                          spm.parse_model_proto(sp_model_from_bpe(bpe))))):
        t0 = time.perf_counter()
        ids = [tok.encode(t) for t in texts]
        dt = time.perf_counter() - t0
        n = sum(map(len, ids))
        rates[name] = (n, dt, tok.vocab_size)
        if name == "TokenizerJSON" and ids != [bpe.encode(t) for t in texts]:
            raise AssertionError("run (l): the tokenizer.json of runs/parity/tok and the "
                                 "GPT-2 BPE give other ids over the repo's *.md")
    print(f"[tok] {len(texts)} *.md files, {sum(map(len, texts))} characters on the host of "
          f"{card}: " + "; ".join(
              f"{name} (vocabulary {v}) {n} tokens in {dt:.3f} s, {n / dt:.0f} tokens/s"
              for name, (n, dt, v) in rates.items())
          + "; TokenizerJSON ids == BPETokenizer ids", flush=True)
    return spec


L1_ARGS = [a for a in SFT_ARGS if a not in ("--model_name", "llama2_7b")]


def hf_leg1(tmp: str, gen, card: str, spec: dict, d_rows: list) -> None:
    """Run (l1): ``run_sft --model_path`` at Llama-2-7B's full width and
    depth from a written HF directory, NF4, its tokenizer.json, PEFT out."""
    cfg = LlamaConfig.llama2_7b(vocab_size=L_VOCAB, param_dtype=torch.bfloat16)
    ckpt, adapters_dir = f"{tmp}/l1_llama2_7b_hf", f"{tmp}/l1_adapters"
    with RssWatch() as wrote:
        kept, write_s = write_llama_checkpoint(
            ckpt, cfg, seed=11, tokenizer=spec,
            keep=("lm_head", ("blocks", "0"), ("blocks", str(cfg.n_layer - 1))))
    nbytes = dir_bytes(ckpt)
    shards = sorted(n for n in os.listdir(ckpt) if n.endswith(".safetensors"))
    index = " + model.safetensors.index.json" if len(shards) > 1 else ""
    print(f"[hf] (l1) wrote {ckpt.rsplit('/', 1)[1]}: {shards}{index}, {nbytes:,} bytes in "
          f"{write_s:.1f} s ({nbytes / write_s / 1e9:.2f} GB/s, page cache dropped after); "
          f"{wrote.text('the init and write')}", flush=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with ImportTimer("llama_from_hf") as timer, RssWatch() as leg:
        trainer, model, adapters = run_sft.main(L1_ARGS + [
            "--model_path", ckpt, "--tokenizer_name", ckpt, "--adapter_output", adapters_dir])
    wall = time.perf_counter() - t0
    launches, peak = read_counts(), torch.cuda.max_memory_allocated()
    rows = [r for r in trainer.history if "loss" in r]
    if len(rows) != STEPS or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"run (l1): expected {STEPS} finite losses, got {rows}")
    # the imported leaves: the written bfloat16 ones through float32 and NF4
    base = dict(iter_paths(model.params))
    for path, want in kept.items():
        got = base[path]
        if isinstance(got, quant.QuantizedTensor):  # through float32, then NF4
            ref = quant.quantize_leaf(want.float())
            same = torch.equal(got.codes, ref.codes) and torch.equal(got.absmax, ref.absmax)
        else:
            same = torch.equal(got, want.float())
        if not same:
            raise AssertionError(f"run (l1): imported leaf {'/'.join(path)} differs from the "
                                 "written one through the JAX dtype rule")
    # the kernels launch as in run (d): the eval rows of this tokenizer
    tok = TokenizerJSON(spec)
    args = run_sft.SFTArguments()
    train, valid = run_sft.sft_records(args)
    _, eval_rows = run_sft.sft_batches(args, tok, train, valid, trainer.global_train_batch(),
                                       trainer.cfg.seed, run_sft.chars_token_ratio(train, tok))
    n_eval = 0 if eval_rows is None else len(eval_rows)
    per_dev = min(trainer.cfg.per_device_eval_batch_size, max(n_eval, 1))
    eval_batches = min(trainer.cfg.eval_iters, n_eval // per_dev)
    expect("(l1)", launches, {
        **optimizer_launches(trainer, STEPS),
        "flash_attention_fwd_hd128": LLAMA_LAYERS * (ACCUM * 2 * STEPS + eval_batches),
        "flash_attention_bwd_dkv_hd128": LLAMA_LAYERS * ACCUM * STEPS,
        "flash_attention_bwd_dq_hd128": LLAMA_LAYERS * ACCUM * STEPS,
        "flash_attention_di_hd128": LLAMA_LAYERS * ACCUM * STEPS, **NO_HD64})
    back, _ = hf_import.peft_to_lora(adapters_dir, model.cfg, device="cuda")
    if back.keys() != adapters.keys() or not all(
            torch.equal(back[p][k], adapters[p][k].detach()) for p in adapters for k in "AB"):
        raise AssertionError("run (l1): peft_to_lora(--adapter_output) differs from the "
                             "trainer's adapters")
    step = statistics.median(r["step_ms"] for r in rows[1:])
    d_step = statistics.median(r["step_ms"] for r in d_rows[1:])
    print(f"[hf] (l1) run_sft --model_path (Llama-2-7B, {model.cfg.n_layer} layers, vocabulary "
          f"{model.cfg.vocab_size}, "
          f"tokenizer.json {tok.vocab_size} ids, NF4) on {card}: import {nbytes:,} bytes "
          f"(disk to device-resident tree) {timer.seconds:.1f} s, "
          f"{nbytes / timer.seconds / 1e9:.2f} GB/s, of which quantizing {timer.quant_s:.1f} s; "
          f"losses {[round(r['loss'], 4) for r in rows]}; steps 2-{STEPS} "
          f"{[r['step_ms'] for r in rows[1:]]} ms, median {step:.1f} ms/step beside run (d)'s "
          f"{d_step:.1f}; peak device memory {peak / 2**30:.2f} GiB; run_sft.main {wall:.1f} s; "
          f"{eval_batches} eval batch(es); launches {launches}; {timer.rss.text('the import')}; "
          f"{leg.text('run_sft.main')}; {rss_text()}; the first and "
          "last blocks and the head == the written leaves through float32 and quantize_leaf; "
          "peft_to_lora(--adapter_output) == the trainer's adapters", flush=True)
    del trainer, model, adapters, back, kept
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()


def hf_leg2(tmp: str, card: str, spec: dict) -> None:
    """Run (l2): an HF ``--merged_output`` and ``--adapter_output`` at
    Llama-2-7B's width and 2 layers, read back; then ``--adapter_path``."""
    cfg = LlamaConfig.llama2_7b(vocab_size=L_VOCAB, n_layer=L2_LAYERS,
                                param_dtype=torch.bfloat16)
    ckpt, adapters_dir, merged_dir = (f"{tmp}/l2_hf", f"{tmp}/l2_adapters", f"{tmp}/l2_merged")
    write_llama_checkpoint(ckpt, cfg, seed=12, tokenizer=spec)
    one = L1_ARGS + ["--max_steps", "1", "--model_path", ckpt, "--tokenizer_name", ckpt]
    trainer, model, adapters = run_sft.main(one + ["--adapter_output", adapters_dir,
                                                   "--merged_output", merged_dir])
    lora_cfg = LoraConfig(r=8, alpha=16, dropout=0.05)
    want = quant.dequantize_tree(merge_lora(model.params, adapters, lora_cfg))
    t0 = time.perf_counter()
    back, _ = hf_import.llama_from_hf(merged_dir, device="cuda")
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    changed = changed_leaves(back, want)
    if changed:
        raise AssertionError(f"run (l2): the HF --merged_output read back differs from "
                             f"dequantize_tree(merge_lora(base, adapters)) at {changed[:8]}")
    merged_bytes = dir_bytes(merged_dir)
    del back, want, model, trainer
    torch.cuda.empty_cache()
    with ImportTimer("peft_to_lora") as timer:
        trainer2, _, adapters2 = run_sft.main(one + ["--adapter_path", adapters_dir])
    start = timer.result[0]
    rows = [r for r in trainer2.history if "loss" in r]
    if (start.keys() != adapters.keys()
            or not all(torch.equal(start[p][k], adapters[p][k].detach())
                       for p in adapters for k in "AB")
            or len(rows) != 1 or not math.isfinite(rows[0]["loss"])):
        raise AssertionError(f"run (l2): --adapter_path did not start from the written "
                             f"adapters, or its step failed: {rows}")
    print(f"[hf] (l2) Llama-2-7B width, {L2_LAYERS} layers, on {card}: HF --merged_output "
          f"float32 {merged_bytes:,} bytes, read back in {read_s:.1f} s == "
          f"dequantize_tree(merge_lora(base, adapters)); --adapter_path started from the "
          f"--adapter_output adapters (torch.equal) and trained 1 step, loss "
          f"{rows[0]['loss']:.4f}, {rows[0]['step_ms']} ms; {rss_text()}", flush=True)
    del trainer2, adapters2, start, adapters
    for d in (ckpt, merged_dir):
        shutil.rmtree(d)
    torch.cuda.empty_cache()


def hf_leg3(tmp: str, card: str, c_rows: list) -> None:
    """Run (l3): ``run_clm --model_path`` for GPT-2 124M from a written HF
    GPT-2 directory, ``--vocab_pad_multiple 64 --hf_export``."""
    ckpt, export = f"{tmp}/l3_gpt2_hf", f"{tmp}/l3_export"
    cfg = GPT2Config.gpt2_124m()
    written = tree_from_state_dict(GPT2(cfg, device="cuda", seed=13))
    t0 = time.perf_counter()
    hf_export.gpt2_to_hf(written, cfg, ckpt)
    drop_cached(ckpt)
    write_s = time.perf_counter() - t0
    reset_counts()
    with ImportTimer("gpt2_from_hf") as timer:
        trainer = run_clm.main(SLICE_ARGS + ["--dropout", "0", "--model_path", ckpt,
                                             "--vocab_pad_multiple", "64", "--hf_export", export,
                                             "--max_steps", str(STEPS)])
    launches = read_counts()
    rows = [r for r in trainer.history if "loss" in r]
    if len(rows) != STEPS or not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"run (l3): expected {STEPS} finite losses, got {rows}")
    expect("(l3)", launches, {**optimizer_launches(trainer, STEPS), **flash_launches(STEPS)})
    imported = dict(iter_paths(timer.result[0]))  # run_clm padded its wte in place
    wte = imported[("wte",)]
    if (wte.shape[0] != 50_304 or not torch.equal(wte[:GPT2_VOCAB], written["wte"].detach())
            or wte[GPT2_VOCAB:].any()):
        raise AssertionError(f"run (l3): the imported wte {tuple(wte.shape)} is not the written "
                             "one with zero alignment rows")
    changed = [p for p, t in iter_paths(written) if p != ("wte",)
               and not torch.equal(imported[p], t.detach())]
    exported, _ = hf_import.gpt2_from_hf(export, device="cuda")
    final = tree_from_state_dict(trainer.model)
    final["wte"] = final["wte"][:GPT2_VOCAB]
    final = dict(iter_paths(final))
    changed += [("export",) + p for p, t in iter_paths(exported)
                if not torch.equal(t, final[p].detach())]
    if changed:
        raise AssertionError(f"run (l3): leaves differ: {changed[:8]}")
    nbytes = dir_bytes(ckpt)
    step = statistics.median(r["step_ms"] for r in rows[1:])
    c_step = statistics.median(r["step_ms"] for r in c_rows[1:])
    print(f"[hf] (l3) run_clm --model_path GPT-2 124M (vocabulary {GPT2_VOCAB} padded to "
          f"{wte.shape[0]}) on {card}: wrote {nbytes:,} bytes in {write_s:.1f} s; import "
          f"{timer.seconds:.2f} s, {nbytes / timer.seconds / 1e9:.2f} GB/s; --hf_export "
          f"{dir_bytes(export):,} bytes; losses {[round(r['loss'], 4) for r in rows]}; steps "
          f"2-{STEPS} {[r['step_ms'] for r in rows[1:]]} ms, median {step:.1f} ms/step beside "
          f"run (c)'s {c_step:.1f}; launches {launches}; {rss_text()}; imported == written "
          "with zero pad rows, the export read back == the final weights", flush=True)
    del trainer, exported, final, timer, imported, wte, written
    for d in (ckpt, export):
        shutil.rmtree(d)
    torch.cuda.empty_cache()


def hf_phase(tmp: str, gen, card: str, d_rows: list, c_rows: list) -> None:
    """Run (l): start from and end in Hugging Face checkpoints."""
    free = shutil.disk_usage(tmp).free
    print(f"[hf] scratch {tmp}: {free / 1e9:.1f} GB free", flush=True)
    spec = tokenizer_check(card)
    t = time.perf_counter()
    hf_leg1(tmp, gen, card, spec, d_rows)
    t = phase_time("slice (l1), run_sft from an HF Llama-2-7B", t)
    hf_leg2(tmp, card, spec)
    t = phase_time("slice (l2), HF --merged_output and --adapter_path", t)
    hf_leg3(tmp, card, c_rows)
    phase_time("slice (l3), run_clm from an HF GPT-2 124M", t)


def slice_phase(tmp, gen, card, rates):
    t = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1)
    try:
        wire_check(gen)
        base, base_rows, base_launches = run_counted([])
        buckets = len(bucket_bounds(base.n_params, base.cfg.vote_buckets, base.world,
                                    base.cfg.wire))
        expect("default", base_launches, {
            "fused_ballots": STEPS * buckets, "fused_apply": STEPS * buckets,
            "bucket_vote_stats": 0, "flash_attention_fwd": N_LAYER * EVAL_BATCHES,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0, "flash_attention_di": 0,
            **NO_HD128})
        del base
        torch.cuda.empty_cache()
        trainer, rows, launches = run_counted(["--dropout", "0", "--telemetry"])
        expect("dropout 0 + telemetry", launches, {
            "fused_ballots": STEPS * buckets, "fused_apply": STEPS * buckets,
            "bucket_vote_stats": STEPS * buckets,
            "flash_attention_fwd": N_LAYER * ACCUM * 2 * STEPS + N_LAYER * EVAL_BATCHES,
            "flash_attention_bwd_dkv": N_LAYER * ACCUM * STEPS,
            "flash_attention_bwd_dq": N_LAYER * ACCUM * STEPS,
            "flash_attention_di": N_LAYER * ACCUM * STEPS, **NO_HD128})
        for r in rows:
            if r["vote/hist_mass"] != 1.0 or r["vote/disagree_frac"] != 0.0:
                raise AssertionError(
                    f"a vote of one rank: hist_mass {r['vote/hist_mass']}, disagree_frac "
                    f"{r['vote/disagree_frac']} at step {r['step']}")
        _, eval_blocks = run_clm.load_blocks(run_clm.DataArguments(synthetic_blocks=400), 1024,
                                             trainer.model.cfg.vocab_size)
        flash_vs_xla_eval(trainer, trainer.model, eval_blocks, "GPT-2 (b)")
        world, wire, buckets_cfg = trainer.world, trainer.cfg.wire, trainer.cfg.vote_buckets
        del trainer
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        plain, plain_rows, plain_launches = run_counted(["--dropout", "0"])
        plain_peak = torch.cuda.max_memory_allocated()
        expect("dropout 0", plain_launches, dict(launches, bucket_vote_stats=0))
        # (c)'s end state, before the journal run's profiled step moves it
        plain_end = (plain.flat.params.detach().cpu(), plain.state.exp_avg.cpu())
        profile_step(plain, plain.model, gen, 8, "GPT-2 (c)")
        journal_run(tmp, plain, plain_rows, plain_launches, card)
        del plain
        torch.cuda.empty_cache()
        dots_run(plain_end, plain_rows, plain_launches, plain_peak, card)
        del plain_end
        t = phase_time("slice (a)-(c), GPT-2 124M", t)
        phases = {"chunk": chunk_run(card)}
        t = phase_time("[chunk], GPT-2 124M --steps_per_call", t)
        phases["generate"] = generate_phase(gen, card)
        t = phase_time("[generate], GPT-2 124M and Llama-3-8B widths", t)
        phases["serve"] = serve_phase(tmp, gen, card)
        t = phase_time("[serve], GPT-2 124M and Llama-3-8B widths", t)
        moe = moe_one_rank(gen, card)
        t = phase_time("slice (y1), GPT-2-MoE", t)
        stoch, stoch_rows, stoch_launches = run_counted(STOCH_ARGS)
        # the stochastic ballots and update are plain PyTorch, as the JAX
        # package's XLA path; the flash kernels run as in (c)
        expect("(e) dropout 0 + max_grad_norm", stoch_launches,
               dict(plain_launches, fused_ballots=0, fused_apply=0))
        if stoch.cfg.max_grad_norm != STOCH_MGN:
            raise AssertionError(f"run (e): max_grad_norm {stoch.cfg.max_grad_norm}")
        del stoch
        torch.cuda.empty_cache()
        stochastic_check(gen)
        t = phase_time("slice (e), GPT-2 124M stochastic", t)
        sentinel_run(tmp, card)
        t = phase_time("slice (n), the NaN sentinel", t)
        mode_runs, mode_times = modes_phase(gen, card)
        t = time.perf_counter()
        llama = llama_run(gen)
        t = phase_time("slice (d), Llama-2-7B", t)
        dpo = dpo_run(gen)
        t = phase_time("slice (j), Llama-2-7B DPO", t)
        llama3 = llama3_run(gen, rates)
        xent = xent_check(gen)
        phase_time("slice (k), Llama-3-8B full-parameter, and [xent]", t)
        resume_phase(tmp, card)
        hf_phase(tmp, gen, card, llama[0], plain_rows)
    finally:
        dist.destroy_process_group()
    print(f"[stochastic] run (e) - run (c), median step: "
          f"{statistics.median(r['step_ms'] for r in stoch_rows[1:]) - statistics.median(r['step_ms'] for r in plain_rows[1:]):.1f} "
          f"ms on the host clock (the optimizer step alone: "
          f"{mode_times['stochastic'] - mode_times['fused']:.4f} ms more device time)",
          flush=True)
    return (world, wire, buckets_cfg), [
        ("(a) default (dropout 0.1)", base_rows, base_launches),
        ("(b) dropout 0 + telemetry", rows, launches),
        ("(c) dropout 0", plain_rows, plain_launches),
        ("(e) dropout 0 + max_grad_norm 1.0 (stochastic)", stoch_rows, stoch_launches),
        ("(y1) GPT-2-MoE, 8 experts every 2 blocks, dropout 0 + telemetry (peak device memory "
         f"{moe[2] / 2**30:.2f} GiB; {N_MOE:,} coordinates)", moe[0], moe[1]),
        *mode_runs], llama, dpo, mode_times, llama3, xent, phases


def moe_one_rank(gen, card: str) -> tuple:
    """Run (y1): GPT-2-MoE at full width and depth in the 1-rank group,
    (b)'s setup with MOE_ARGS: finite losses, N_MOE coordinates, (b)'s
    launch formulas (every block's attention takes flash), ``vote/hist_mass
    == 1``, eval through flash within EVAL_TOL of attention_xla's; then one
    MoE block's routing on the card (:func:`routing_check`) and a profiled
    microbatch. Returns (rows, launches, peak bytes)."""
    torch.cuda.reset_peak_memory_stats()
    trainer, rows, launches = run_counted(Y1_ARGS)
    peak = torch.cuda.max_memory_allocated()
    expect("(y1) GPT-2-MoE", launches, dict(optimizer_launches(trainer, STEPS),
                                            **flash_launches(STEPS)))
    if trainer.n_params != N_MOE or any(r["vote/hist_mass"] != 1.0 for r in rows):
        raise AssertionError(f"run (y1): {trainer.n_params:,} coordinates (expected {N_MOE:,}), "
                             f"rows {rows}")
    _, eval_blocks = run_clm.load_blocks(run_clm.DataArguments(synthetic_blocks=400), 1024,
                                         trainer.model.cfg.vocab_size)
    flash_vs_xla_eval(trainer, trainer.model, eval_blocks, "GPT-2-MoE (y1)")
    routing_check(trainer.model, gen, card)
    profile_step(trainer, trainer.model, gen, 8, "GPT-2-MoE (y1)")
    del trainer
    torch.cuda.empty_cache()
    return rows, launches, peak


@torch.no_grad()
def routing_check(model, gen, card: str) -> None:
    """The first MoE block's routing of a microbatch (B 8 x T 1024 random
    tokens through the trained model up to that block's FFN) on the card:
    every kept token in a slot of its own, and each expert's drops
    ``max(0, count - C)`` with C = ``capacity(8192, 8, 1.25)``."""
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen, device="cuda")
    x = model.wte[tokens].to(cfg.compute_dtype) + model.wpe[:1024].to(cfg.compute_dtype)
    block = next(b for b in model.blocks if hasattr(b, "moe"))
    for b in model.blocks:
        if b is block:
            break
        x = b(x, cfg, None)
    x = x + block.attn(gpt2_layer_norm(x, block.ln_1), cfg, None)
    h = gpt2_layer_norm(x, block.ln_2).reshape(-1, cfg.d_model)
    n, cap = h.shape[0], capacity(h.shape[0], MOE_E, cfg.moe_capacity_factor)
    _, idx, pos, keep = route(h, block.moe.gate, MOE_E, cap)
    counts = torch.bincount(idx, minlength=MOE_E)
    kept = torch.bincount(idx[keep], minlength=MOE_E)
    slots = (idx * cap + pos)[keep]
    unique = torch.unique(slots).numel() == slots.numel()
    drops = (counts - kept).tolist()
    want = [max(0, c - cap) for c in counts.tolist()]
    print(f"[slice] (y1) routing of the first MoE block on {card}: {n} tokens, capacity {cap}, "
          f"tokens per expert {counts.tolist()}, drops {drops} (max(0, count - C) {want}), every "
          f"kept token in a slot of its own {unique}", flush=True)
    if not unique or drops != want:
        raise AssertionError(f"run (y1) routing: slots unique {unique}, drops {drops} != {want}")


def dots_run(plain_end: tuple, plain_rows: list, plain_launches: dict, plain_peak: int,
             card: str) -> None:
    """Run (c-dots): (c) with ``--remat_policy dots`` (each block keeps the
    outputs of its products without batch dims and recomputes the rest).
    Its losses, final params and momentum must be ``torch.equal`` to (c)'s
    and its launches (c)'s (the flash kernels are recomputed either way);
    its peak device memory and median step are printed beside (c)'s."""
    torch.cuda.reset_peak_memory_stats()
    dots, rows, launches = run_counted(["--dropout", "0", "--remat_policy", "dots"])
    peak = torch.cuda.max_memory_allocated()
    expect("(c-dots)", launches, plain_launches)
    same = {"losses": [r["loss"] for r in rows] == [r["loss"] for r in plain_rows],
            "params": torch.equal(dots.flat.params.detach().cpu(), plain_end[0]),
            "momentum": torch.equal(dots.state.exp_avg.cpu(), plain_end[1])}
    if dots.model.cfg.remat_policy != "dots" or not all(same.values()):
        raise AssertionError(f"run (c-dots): policy {dots.model.cfg.remat_policy}, equal to "
                             f"(c) {same}")
    del dots
    torch.cuda.empty_cache()
    med, plain_med = (statistics.median(r["step_ms"] for r in rs[1:])
                      for rs in (rows, plain_rows))
    print(f"[slice] (c-dots) --dropout 0 --remat_policy dots: GPT-2 124M, 1 rank, losses "
          f"{[round(r['loss'], 4) for r in rows]}, torch.equal to (c)'s {same}; steps 2-"
          f"{len(rows)} {[r['step_ms'] for r in rows[1:]]} ms, median {med:.1f} ms/step beside "
          f"(c)'s {plain_med:.1f}; peak device memory {peak / 2**30:.2f} GiB beside (c)'s "
          f"{plain_peak / 2**30:.2f} GiB on {card}; launches (c)'s", flush=True)


@torch.no_grad()
def mixed_phase(gen, card: str) -> dict:
    """[mixed]: one Distributed Lion step (a world of one, MIXED_BUCKETS
    buckets, weight decay MIXED_WD) over GPT-2 124M's leaves as a mixed tree
    in leaf order, its matrices bfloat16 and its biases and LayerNorm params
    float32 (momenta in the params' dtypes), from random params, grads and
    momenta, with every kernel counter at 0 before and read after: each
    kernel must launch once a window of each bucket, on the window's dtype.
    Params and momenta must be ``torch.equal`` to the plain per-window
    version of the same step (``fused_ballots_plain`` of each window, the
    one-rank election of the bucket, ``fused_apply_plain`` of each window).
    Prints the step's device time (median of RUNS CUDA-event runs). Returns
    the checked step's launches per entry of KERNELS."""
    model = GPT2(GPT2Config.gpt2_124m(), device=MIXED_DEVICE, seed=0)
    flat = FlatParams([(name, torch.nn.Parameter(
        p.detach().to(torch.bfloat16 if p.dim() >= 2 else torch.float32)))
        for name, p in jax_leaf_order(list(model.named_parameters()))])
    del model
    opt = DistributedLion(3e-4, weight_decay=MIXED_WD, vote_buckets=MIXED_BUCKETS)
    state = opt.init(flat)
    for buf in (*flat.param_bufs, *flat.grad_bufs, *momenta(state)):
        buf.copy_(torch.randn(buf.numel(), generator=gen, device=MIXED_DEVICE))
    ps, ms = [b.clone() for b in flat.param_bufs], [b.clone() for b in momenta(state)]
    gs = flat.grad_bufs
    lr = resolve_lr(opt.learning_rate, state.count)
    reset_counts()
    state = opt.step(flat, state)
    launches = split_counts(p_bf16=True)
    windows = {"float32": 0, "bfloat16": 0}
    for start, size in bucket_bounds(flat.numel, MIXED_BUCKETS, 1, "sign_psum"):
        runs = flat.runs(start, start + size)
        ballots = torch.cat([fused_lion.fused_ballots_plain(gs[k][a:b], ms[k][a:b], opt.b1)
                             for k, a, b, _ in runs])
        _, tally = plain_election([ballots], "sign_psum")
        for k, a, b, rel in runs:
            ps[k][a:b], ms[k][a:b] = fused_lion.fused_apply_plain(
                ps[k][a:b], gs[k][a:b], ms[k][a:b], tally[rel:rel + b - a], lr, MIXED_WD,
                opt.b2)
            windows[str(ms[k].dtype)[6:]] += 1
    equal = {"params": all(map(torch.equal, flat.param_bufs, ps)),
             "momenta": all(map(torch.equal, momenta(state), ms))}
    want = dict.fromkeys(KERNELS, 0)
    for k in BY_DTYPE:
        want[k], want[k + "_p_bf16"] = windows["float32"], windows["bfloat16"]
    if not (all(equal.values()) and launches == want and all(windows.values())):
        raise AssertionError(f"[mixed]: equal to the plain per-window step {equal}, windows "
                             f"{windows}, launches {launches} against {want}")
    del ps, ms
    step_ms = time_ms(lambda: opt.step(flat, state))
    sizes = {str(b.dtype)[6:]: b.numel() for b in flat.param_bufs}
    print(f"[mixed] Distributed Lion, 1 rank, {MIXED_BUCKETS} buckets, GPT-2 124M's "
          f"{len(flat.names)} leaves as a mixed tree ({sizes['float32']:,} float32 and "
          f"{sizes['bfloat16']:,} bfloat16 coordinates in {windows['float32']} and "
          f"{windows['bfloat16']} windows): params and momenta torch.equal to the plain "
          f"per-window step; launches {launches}; step {step_ms:.4f} ms of device time on "
          f"{card}", flush=True)
    return launches


def chunk_run(card: str) -> dict:
    """Run [chunk]: (c) (``--dropout 0``) for CHUNK_STEPS steps step by step,
    then in chunks of CHUNK_K (``--steps_per_call``), each with every kernel
    counter at 0 before and read after. The two runs' final params and
    momentum must be ``torch.equal``, their launches equal to each other and
    to (c)'s formulas, and each chunk's logged loss the mean of its steps'.
    Prints both runs' steps (host clock; not a claim). Returns the chunked
    run's launches."""
    runs = []
    for extra in ([], ["--steps_per_call", str(CHUNK_K)]):
        reset_counts()
        trainer = run_clm.main(SLICE_ARGS + ["--dropout", "0"] + extra
                               + ["--max_steps", str(CHUNK_STEPS)])
        launches = read_counts()
        want = dict(optimizer_launches(trainer, CHUNK_STEPS), **flash_launches(CHUNK_STEPS))
        expect(f"[chunk] {extra or 'step by step'}", launches, want)
        # (c)'s params and momenta are float32: no bfloat16 instantiation runs
        split = split_counts(p_bf16=False)
        if any(split[k + sfx] for k in BY_DTYPE for sfx in ("_mom_bf16", "_p_bf16")):
            raise AssertionError(f"[chunk] {extra or 'step by step'}: launches by dtype {split}")
        runs.append(([r for r in trainer.history if "loss" in r], split,
                     trainer.flat.params.detach().clone(), trainer.state.exp_avg.clone()))
        del trainer
        torch.cuda.empty_cache()
    (rows1, l1, p1, m1), (rowsk, lk, pk, mk) = runs
    means = [statistics.mean(r["loss"] for r in rows1[i:i + CHUNK_K])
             for i in range(0, CHUNK_STEPS, CHUNK_K)]
    same = {"params": torch.equal(p1, pk), "momentum": torch.equal(m1, mk),
            "launches": l1 == lk, "logged steps": [r["step"] for r in rowsk] == list(
                range(CHUNK_K, CHUNK_STEPS + 1, CHUNK_K)),
            "chunk-mean losses": all(math.isclose(r["loss"], m, rel_tol=1e-6)
                                     for r, m in zip(rowsk, means))}
    print(f"[chunk] run (c) --dropout 0, GPT-2 124M, 1 rank, {CHUNK_STEPS} steps: step by step "
          f"{[round(r['step_ms'], 1) for r in rows1]} ms/step (median of steps 2-{CHUNK_STEPS} "
          f"{statistics.median(r['step_ms'] for r in rows1[1:]):.1f}); --steps_per_call "
          f"{CHUNK_K} {[round(r['step_ms'], 1) for r in rowsk]} ms/step a chunk, on the host "
          f"clock, not a claim; equal {same}; launches {lk} on {card}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"[chunk]: {same}")
    return lk


def decode_recorder(decode):
    """``decode`` that also keeps each call's logits and CUDA events around
    it (no host read)."""
    rec = {"logits": [], "events": []}

    def fn(params, tokens, cache, pos, offset=None):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = decode(params, tokens, cache, pos, offset)
        end.record()
        rec["logits"].append(out[0])
        rec["events"].append((start, end))
        return out

    return fn, rec


def row_logits(rec: dict, row: int, n: int) -> torch.Tensor:
    """A row's logits at its own positions: its n prompt positions of the
    prefill (right-aligned), then each decode step's."""
    prefill = rec["logits"][0][row, -n:]
    return torch.cat([prefill] + [lg[row, -1:] for lg in rec["logits"][1:]])


@torch.no_grad()
def f32_anchored(label: str, got: torch.Tensor, seq: torch.Tensor, forward, forward32,
                 start: int = 0) -> tuple:
    """``got``, the logits at positions ``start`` onwards of ``seq``
    ``[1, T]``, against ``forward32`` (the same weights at float32 compute,
    materialized attention) on ``seq``: ``max|got - f32| <= 2 max|forward -
    f32| + 2^-8 max|f32|``, ``forward`` the bfloat16 model; or, with
    ``forward`` None (``got`` computed at float32 too), ``max|got - f32| <=
    F32_REL max|f32|``. Raises otherwise; returns (max|got - f32|,
    max|forward - f32| or 0, the bound)."""
    ref = forward32(seq)[0, start:]
    e_got = float((got.float() - ref).abs().max())
    if forward is None:
        e_fwd, tol = 0.0, F32_REL * float(ref.abs().max())
    else:
        e_fwd = float((forward(seq)[0, start:].float() - ref).abs().max())
        tol = 2 * e_fwd + 2 ** -8 * float(ref.abs().max())
    if got.shape != ref.shape or not e_got <= tol:
        raise AssertionError(
            f"{label}: logits {tuple(got.shape)} against {tuple(ref.shape)}, max|got - f32| "
            f"{e_got} > " + ("F32_REL max|f32|" if forward is None else
                             "2 max|forward - f32| + 2^-8 max|f32|") + f" = {tol}")
    return e_got, e_fwd, tol


@torch.no_grad()
def generate_check(label: str, cfg, params, decode, init_cache, forward, forward32, gen,
                   card: str) -> dict:
    """[generate] of one model: GEN_LENS prompts of random tokens in one
    left-padded batch, GEN_NEW greedy tokens, with every kernel counter at 0
    before and read after (decoding launches none). Each row's prefill and
    decode logits are held to ``forward`` (the model's own forward, bfloat16
    compute, flash) on the row's prompt and tokens: against ``forward32``
    (the same weights at float32 compute, materialized attention),
    ``max|decode - f32| <= 2 max|forward - f32| + 2^-8 max|f32|``. Each row
    is then decoded solo: the tokens equal up to the first one whose solo
    top-2 margin is below the batched-vs-solo logit gap measured up to it
    (cuBLAS may take other algorithms at another batch size). Prints prefill
    ms, ms a decode token (CUDA events), tokens/s (host clock around the
    whole call) and peak device memory, after an untimed two-token call on
    the same batch."""
    B, T = len(GEN_LENS), max(GEN_LENS)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=GEN_DEVICE)
               for n in GEN_LENS]
    batch = torch.zeros(B, T, dtype=torch.long, device=GEN_DEVICE)
    for i, p in enumerate(prompts):
        batch[i, T - len(p):] = p
    lens = torch.tensor(GEN_LENS, device=GEN_DEVICE)
    # untimed: the first calls' allocator growth and cuBLAS setup at these shapes
    generate(decode, init_cache, params, batch, 2, prompt_lens=lens)
    dec, rec = decode_recorder(decode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = generate(dec, init_cache, params, batch, GEN_NEW, prompt_lens=lens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = split_counts(p_bf16=False)   # no optimizer step: every entry must stay 0
    peak = torch.cuda.max_memory_allocated()
    if any(launches.values()):
        raise AssertionError(f"[generate] {label}: decoding launched kernels {launches}")
    prefill_ms = rec["events"][0][0].elapsed_time(rec["events"][0][1])
    token_ms = statistics.mean(s.elapsed_time(e) for s, e in rec["events"][1:])
    err, gaps, diverged = [], [], []
    for i, p in enumerate(prompts):
        n = len(p)
        seq = torch.cat([p, out[i, :-1]])[None]
        got = row_logits(rec, i, n)
        e_dec, e_fwd, _ = f32_anchored(f"[generate] {label} row {i}", got, seq, forward,
                                       forward32)
        err.append((round(e_dec, 5), round(e_fwd, 5)))
        sdec, srec = decode_recorder(decode)
        solo = generate(sdec, init_cache, params, p[None], GEN_NEW)[0]
        alone = row_logits(srec, 0, n)
        differ = torch.nonzero(solo != out[i]).flatten().tolist()
        last = n - 1 + (differ[0] if differ else GEN_NEW - 1)   # inputs equal up to here
        gap = float((got[:last + 1] - alone[:last + 1]).abs().max())
        gaps.append(round(gap, 5))
        if differ:
            top2 = torch.topk(alone[last], 2).values
            margin = float(top2[0] - top2[1])
            diverged.append((i, differ[0], round(margin, 5)))
            if not margin <= gap:
                raise AssertionError(
                    f"[generate] {label} row {i}: solo and batched tokens part at {differ[0]} "
                    f"where the solo top-2 margin {margin} exceeds the logit gap {gap}")
    print(f"[generate] {label}: B {B}, prompts {list(GEN_LENS)} left-padded, {GEN_NEW} greedy "
          f"tokens: prefill {prefill_ms:.2f} ms, {token_ms:.3f} ms a decode token, "
          f"{B * GEN_NEW / wall:.0f} tokens/s ({wall:.2f} s for the call), peak device memory "
          f"{peak / 2**30:.2f} GiB; max|decode - f32| vs max|forward - f32| by row {err}; "
          f"batched-vs-solo logit gap by row {gaps}, rows parting from solo (row, token, solo "
          f"margin) {diverged}; no kernel launched; on {card}", flush=True)
    return launches


def generate_phase(gen, card: str) -> dict:
    """[generate]: GPT-2 124M at full width and depth (random weights from
    seed 0, bfloat16 compute), then Llama-3-8B's widths (GQA 32/8,
    vocabulary 128,256, rope theta 500,000) cut to GEN_LLAMA_LAYERS layers,
    bfloat16 params, through :func:`generate_check`; then one
    ``run_generate.main`` (GPT-2 124M, byte vocabulary, random init) over a
    ``--prompt_file`` of three prompts, with no kernel launched. Returns the
    three decodes' launches summed, per entry of KERNELS."""
    cfg = GPT2Config.gpt2_124m()
    model = GPT2(cfg, device=GEN_DEVICE, seed=0).eval()
    model32 = GPT2(dataclasses.replace(cfg, compute_dtype=torch.float32, attn_impl="xla"),
                   device=GEN_DEVICE, seed=0).eval()
    counts = [generate_check(
        "GPT-2 124M", cfg, tree_from_state_dict(model),
        lambda p, t, k, pos, off=None: gpt2_decode(p, t, cfg, k, pos, off),
        lambda b, n: gpt2_init_cache(cfg, b, n, device=GEN_DEVICE), model, model32, gen, card)]
    del model, model32
    torch.cuda.empty_cache()
    lcfg = LlamaConfig.llama3_8b(n_layer=GEN_LLAMA_LAYERS, param_dtype=torch.bfloat16)
    params = llama_init(lcfg, seed=0, device=GEN_DEVICE)
    counts.append(generate_check(
        f"Llama-3-8B widths, {GEN_LLAMA_LAYERS} layers", lcfg, params,
        lambda p, t, k, pos, off=None: llama_decode(p, t, lcfg, k, pos, off),
        lambda b, n: llama_init_cache(lcfg, b, n, device=GEN_DEVICE), Llama(lcfg, params),
        Llama(dataclasses.replace(lcfg, compute_dtype=torch.float32, attn_impl="xla"), params),
        gen, card))
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "prompts.txt")
        pathlib.Path(path).write_text("\n".join(GEN_FILE_PROMPTS) + "\n")
        reset_counts()
        texts = run_generate.main(["--model_name", "gpt2_124m", "--prompt_file", path,
                                   "--max_new_tokens", "16", "--temperature", "0"])
        launches = split_counts(p_bf16=False)
        counts.append(launches)
    if len(texts) != len(GEN_FILE_PROMPTS) or any(launches.values()):
        raise AssertionError(f"[generate] run_generate.main --prompt_file: {texts!r}, "
                             f"launches {launches}")
    print(f"[generate] run_generate.main --model_name gpt2_124m --prompt_file (3 prompts), 16 "
          f"greedy tokens a row: {len(texts)} texts, no kernel launched, on {card}", flush=True)
    return {k: sum(c[k] for c in counts) for k in KERNELS}


class RecordingEngine(ServingEngine):
    """A :class:`ServingEngine` that also keeps, with no host read, each
    dispatch of the model between two CUDA events (its kind, and the
    bucket or the batch) and the float32 logits every request sampled from:
    the prefill's at the prompt's last position, each decode tick's last
    column with the request each row held."""

    def __init__(self, model: ServeModel, cfg: ServeConfig):
        self.calls, self.ticks, self.first = [], [], {}
        self._prefill = None
        inner = model.decode_paged

        def decode(params, toks, pages, tables, pos, valid=None):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            logits, pages = inner(params, toks, pages, tables, pos, valid)
            end.record()
            if self._prefill is not None:
                req_id, last = self._prefill
                self.first[req_id] = logits[0, last].clone()
                self.calls.append(("prefill", toks.shape[1], start, end))
            else:
                ids = [s.req.req_id if s is not None else None for s in self.slots]
                self.ticks.append((ids, logits[:, -1].clone()))
                self.calls.append(("decode", sum(i is not None for i in ids), start, end))
            return logits, pages

        super().__init__(ServeModel(model.family, model.cfg, model.params, decode,
                                    model.n_layer, model.kv_heads, model.head_dim,
                                    model.cache_dtype, model.max_positions), cfg)

    def _dispatch_prefill(self, req, slot, covered, suffix, padded):
        self._prefill = (req.req_id, len(suffix) - 1)
        try:
            return super()._dispatch_prefill(req, slot, covered, suffix, padded)
        finally:
            self._prefill = None

    def logits_of(self, req_id) -> torch.Tensor:
        """``[n_sampled, V]``: the logits each of the request's tokens came from."""
        return torch.stack([self.first[req_id]] + [lg[ids.index(req_id)] for ids, lg in self.ticks
                                                   if req_id in ids])


def held_equal(label: str, got: list, want: list, got_logits, want_logits, cap: float) -> tuple:
    """``[generate]``'s criterion: ``got`` equals ``want`` up to the first
    token where ``want``'s top-2 logit margin is below the logit gap
    measured up to it, and that gap is at most ``cap`` (the float32-anchored
    bound ``got_logits`` were held to), so wrong logits fail however they
    part (raises otherwise). Returns (gap, where they part or None, margin
    there)."""
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) and not differ:
        raise AssertionError(f"[serve] {label}: {len(got)} tokens against {len(want)}")
    last = differ[0] if differ else len(want) - 1
    gap = float((got_logits[:last + 1].float() - want_logits[:last + 1].float()).abs().max())
    if not gap <= cap:
        raise AssertionError(f"[serve] {label}: logit gap {gap} up to token {last} exceeds the "
                             f"float32-anchored bound {cap}")
    if not differ:
        return gap, None, None
    top2 = torch.topk(want_logits[last].float(), 2).values
    margin = float(top2[0] - top2[1])
    if not margin <= gap:
        raise AssertionError(f"[serve] {label}: the tokens part at {last} where the reference's "
                             f"top-2 margin {margin} exceeds the logit gap {gap}")
    return gap, last, margin


def serve_requests(prompts: list, new: int = SERVE_NEW) -> list:
    return [Request(i, [int(t) for t in p.tolist()], new, i) for i, p in enumerate(prompts)]


def serve_run(model, prompts: list, **kw) -> tuple:
    """The prompts through a fresh :class:`RecordingEngine` (SERVE_GEOM,
    greedy), request i visible at tick SERVE_ARRIVE_EVERY·i, every counter
    at 0 before and read after; returns the engine, its completions, the
    host-clock seconds of ``run`` (synchronized) and the launches."""
    engine = RecordingEngine(model, ServeConfig(**SERVE_GEOM, max_new_tokens=SERVE_NEW, **kw))
    reqs = serve_requests(prompts)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done = engine.run(reqs, arrivals={r.req_id: SERVE_ARRIVE_EVERY * r.req_id for r in reqs})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = split_counts(p_bf16=False)
    bad = [(r.req_id, done[r.req_id].reason, len(done[r.req_id].tokens)) for r in reqs
           if done[r.req_id].reason != "length" or len(done[r.req_id].tokens) != SERVE_NEW]
    if bad or any(launches.values()) or engine.stats["serve_retraces"]:
        raise AssertionError(f"[serve] {kw}: completions not at their budget {bad}, launches "
                             f"{launches}, retraces {engine.stats['serve_retraces']}")
    # drained: every page free, or (prefix cache) held by one cache ref alone
    held = int(engine.tables.refs.sum()) if engine.prefix is not None else 0
    if engine.tables.physical_pages != held or any(s is not None for s in engine.slots):
        raise AssertionError(f"[serve] {kw}: pages leaked ({engine.tables.physical_pages} "
                             f"physical, {held} cache refs)")
    return engine, done, wall, launches


def paged_against_dense(cfg, params, prompt, gen, card: str) -> str:
    """GPT-2 124M's paged decode (a shuffled 64-page table of the 512-page
    pool) against its dense decode at the same attended length (1024
    slots): the prefill and SERVE_PAGED_STEPS greedy steps, ``torch.equal``
    where that holds; else each against the same weights at float32
    compute, ``max|paged - f32| <= 2 max|dense - f32| + 2^-8 max|f32|``.
    Returns which held."""
    nbw, bs = SERVE_GEOM["max_blocks_per_seq"], SERVE_GEOM["block_size"]
    pages = kv_cache.init_pages(cfg.n_layer, SERVE_GEOM["num_blocks"], bs, cfg.n_head,
                                cfg.head_dim, cfg.compute_dtype, SERVE_DEVICE)
    table = torch.randperm(SERVE_GEOM["num_blocks"], generator=gen,
                           device=SERVE_DEVICE)[:nbw][None]
    cache = gpt2_init_cache(cfg, 1, nbw * bs, device=SERVE_DEVICE)
    toks, pos, dense_l, paged_l = prompt[None], 0, [], []
    for _ in range(SERVE_PAGED_STEPS + 1):
        d, cache = gpt2_decode(params, toks, cfg, cache, pos)
        p, pages = gpt2_decode_paged(params, toks, cfg, pages, table,
                                     torch.full((1,), pos, device=SERVE_DEVICE))
        dense_l.append(d[0])
        paged_l.append(p[0])
        pos += toks.shape[1]
        toks = torch.argmax(d[:, -1], -1)[:, None]
    if all(torch.equal(a, b) for a, b in zip(dense_l, paged_l)):
        return "torch.equal"
    model32 = GPT2(dataclasses.replace(cfg, compute_dtype=torch.float32, attn_impl="xla"),
                   device=SERVE_DEVICE, seed=0).eval()
    seq = torch.cat([prompt] + [torch.argmax(d[-1:], -1) for d in dense_l[:-1]])[None]
    with torch.no_grad():
        ref = model32(seq)[0]
    dense, paged = torch.cat(dense_l), torch.cat(paged_l)
    e_paged, e_dense = (float((x - ref).abs().max()) for x in (paged, dense))
    tol = 2 * e_dense + 2 ** -8 * float(ref.abs().max())
    if not e_paged <= tol:
        raise AssertionError(f"[serve] paged against dense: max|paged - f32| {e_paged} > 2 "
                             f"max|dense - f32| + 2^-8 max|f32| = {tol}")
    return (f"not torch.equal; float32-anchored bound held: max|paged - f32| {e_paged:.5f}, "
            f"max|dense - f32| {e_dense:.5f}, bound {tol:.5f}")


def llama_serve_run(tmp: str, gen, card: str) -> dict:
    """Llama-3-8B's widths (vocabulary 128,256) cut to SERVE_LLAMA_LAYERS
    layers, random init, through ``cli.run_serve.main --quant nf4`` on a
    request file of SERVE_LLAMA_LENS random prompts (and one text prompt),
    SERVE_LLAMA_NEW greedy tokens each, every counter at 0 before and read
    after. Every record must stop at its budget (``length``) or at the
    tokenizer's EOS; prints the served tree's bytes against bfloat16's."""
    path, out = os.path.join(tmp, "serve_requests.jsonl"), os.path.join(tmp, "serve_out.jsonl")
    lines = [{"id": f"l{i}", "tokens": torch.randint(0, SERVE_LLAMA_VOCAB, (n,), generator=gen,
                                                     device=SERVE_DEVICE).tolist(),
              "arrival_tick": i} for i, n in enumerate(SERVE_LLAMA_LENS)]
    lines.append({"id": "text", "prompt": "Q: what is Lion? A:", "arrival_tick": 1})
    pathlib.Path(path).write_text("".join(json.dumps(d) + "\n" for d in lines))
    built = {}
    build = run_serve.build_engine

    def capture(*args, **kw):
        tok, engine = build(*args, **kw)
        built["engine"] = engine
        return tok, engine

    run_serve.build_engine = capture
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with llama_cut(n_layer=SERVE_LLAMA_LAYERS):
            records = run_serve.main(["--model_family", "llama", "--model_name", SERVE_LLAMA,
                                      "--vocab_size", str(SERVE_LLAMA_VOCAB), "--quant", "nf4",
                                      "--requests", path, "--out", out, "--temperature", "0",
                                      "--max_new_tokens", str(SERVE_LLAMA_NEW),
                                      *SERVE_LLAMA_GEOM])
    finally:
        run_serve.build_engine = build
    wall = time.perf_counter() - t0
    launches = split_counts(p_bf16=False)
    engine = built.pop("engine")
    eos = engine.cfg.eos_id
    bad = [r for r in records if not (
        (r["reason"] == "length" and r["n_generated"] == SERVE_LLAMA_NEW)
        or (r["reason"] == "eos" and r["tokens"][-1] == eos
            and r["n_generated"] <= SERVE_LLAMA_NEW))]
    lens = [r["prompt_len"] for r in records]
    if (bad or any(launches.values()) or [r["id"] for r in records] != [d["id"] for d in lines]
            or lens[:-1] != list(SERVE_LLAMA_LENS)
            or [json.loads(x) for x in pathlib.Path(out).read_text().splitlines()] != records):
        raise AssertionError(f"[serve] run_serve.main Llama nf4: records {bad or records}, "
                             f"launches {launches}")
    n = sum(x.numel() for _, x in iter_paths(engine.model.params))
    served, peak = weight_bytes(engine.params), torch.cuda.max_memory_allocated()
    print(f"[serve] run_serve.main --model_family llama ({SERVE_LLAMA} widths, vocabulary "
          f"{SERVE_LLAMA_VOCAB:,}, {SERVE_LLAMA_LAYERS} layers, {n:,} params) --quant nf4 "
          f"--requests ({len(records)} "
          f"requests, staggered): reasons {sorted({r['reason'] for r in records})}, tokens "
          f"{[r['n_generated'] for r in records]}; weight bytes served {served:,} against "
          f"{2 * n:,} at bfloat16 ({served / (2 * n):.3f}x); peak device memory "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s with the load; no kernel launched; on {card}",
          flush=True)
    del engine
    return launches


def serve_phase(tmp: str, gen, card: str) -> dict:
    """[serve]: GPT-2 124M at full width and depth (random weights from
    seed 0, bfloat16 compute) through the serving engine (SERVE_GEOM: 8
    slots, pages of 16 tokens, 64 a sequence, a pool of 512): 16 requests
    of SERVE_LENS random tokens arriving every SERVE_ARRIVE_EVERY ticks,
    SERVE_NEW greedy tokens each. Every logit a request sampled from is held
    to the float32 forward of its own sequence (:func:`f32_anchored`,
    [generate]'s bound), and its tokens to its solo dense
    ``models.generate.generate`` (:func:`held_equal`, the gap capped at that
    bound); paged against dense on the card (:func:`paged_against_dense`);
    at float32 compute, a prefix-cache run of 16 prompts sharing
    SERVE_PREFIX tokens and SERVE_DUPLICATES repeated whole (copy-on-write)
    against the same prompts unshared: token-identical, every logit of both
    within F32_REL of the float32 forward, fewer physical pages, at least one
    copy-on-write; then :func:`llama_serve_run`. No kernel may launch.
    Prints prefill ms by bucket and ms a decode tick at batch 8 (CUDA
    events), tokens/s over the workload (host clock), peak device memory and
    the pool's bytes. Returns the launches summed over the runs, per entry
    of KERNELS."""
    cfg = GPT2Config.gpt2_124m()
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32, attn_impl="xla")
    gpt2 = GPT2(cfg, device=SERVE_DEVICE, seed=0).eval()
    gpt2_32 = GPT2(cfg32, device=SERVE_DEVICE, seed=0).eval()
    params = tree_from_state_dict(gpt2)
    model = ServeModel.for_gpt2(params, cfg)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=SERVE_DEVICE)
               for n in SERVE_LENS]
    warm = ServingEngine(model, ServeConfig(**SERVE_GEOM, max_new_tokens=2))
    warm.run(serve_requests(prompts, 2))   # untimed: allocator growth, cuBLAS at these shapes
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, done, wall, launches = serve_run(model, prompts)
    peak = torch.cuda.max_memory_allocated()
    pool = sum(t.numel() * t.element_size() for layer in engine.pages for t in layer.values())
    buckets: dict = {}
    for kind, size, start, end in engine.calls:
        buckets.setdefault((kind, size), []).append(start.elapsed_time(end))
    prefill = {b: round(statistics.mean(v), 3) for (k, b), v in sorted(buckets.items())
               if k == "prefill"}
    full = buckets.get(("decode", SERVE_GEOM["max_seqs"]), [])
    if not full:
        raise AssertionError(f"[serve] no decode tick at batch {SERVE_GEOM['max_seqs']}")
    dec = lambda p, t, k, pos, off=None: gpt2_decode(p, t, cfg, k, pos, off)
    init = lambda b, n: gpt2_init_cache(cfg, b, n, device=SERVE_DEVICE)
    solos = []
    for p in prompts:
        sdec, srec = decode_recorder(dec)
        solo = generate(sdec, init, params, p[None], SERVE_NEW)[0].tolist()
        solos.append((solo, row_logits(srec, 0, len(p))[len(p) - 1:]))
    counts = [launches, split_counts(p_bf16=False)]   # the solo decodes launched none either
    errs, gaps, parted = [], [], []
    for i, (p, (solo, want)) in enumerate(zip(prompts, solos)):
        got = engine.logits_of(i)
        seq = torch.cat([p, torch.tensor(done[i].tokens[:-1], device=SERVE_DEVICE)])[None]
        e_got, e_fwd, tol = f32_anchored(f"[serve] request {i}", got, seq, gpt2, gpt2_32,
                                         len(p) - 1)
        errs.append((round(e_got, 5), round(e_fwd, 5)))
        gap, where, margin = held_equal(f"request {i} against its solo dense decode",
                                        done[i].tokens, solo, got, want, tol)
        gaps.append(round(gap, 5))
        if where is not None:
            parted.append((i, where, round(margin, 5)))
    del solos
    print(f"[serve] GPT-2 124M, bfloat16, random weights: {len(prompts)} requests of "
          f"{SERVE_LENS[0]}-{SERVE_LENS[-1]} random tokens, one every {SERVE_ARRIVE_EVERY} ticks, "
          f"{SERVE_NEW} greedy tokens each, {SERVE_GEOM}: {engine.stats['ticks']} ticks, "
          f"{engine.stats['decode_ticks']} decode ticks, {engine.stats['prefill_dispatches']} "
          f"prefills; prefill ms by bucket {prefill}; {statistics.mean(full):.3f} ms a decode "
          f"tick at batch {SERVE_GEOM['max_seqs']} (median {statistics.median(full):.3f}, "
          f"{len(full)} ticks; CUDA events); {len(prompts) * SERVE_NEW / wall:.1f} tokens/s over "
          f"the workload ({wall:.2f} s, host clock, the recording's slices included); peak device "
          f"memory {peak / 2**30:.2f} GiB, pool {pool:,} bytes ({SERVE_GEOM['num_blocks']} pages "
          f"+ the scratch page); on {card}", flush=True)
    print(f"[serve] every sampled logit against the float32 forward of its request's sequence: "
          f"(max|engine - f32|, max|forward - f32|) by request {errs}, each within 2 "
          f"max|forward - f32| + 2^-8 max|f32|; against its solo dense generate: logit gap by "
          f"request {gaps}, each within that bound; requests parting from solo (request, token, "
          f"solo margin) {parted}; no kernel launched; on {card}", flush=True)
    del engine
    held = paged_against_dense(cfg, params, prompts[8], gen, card)
    slots = SERVE_GEOM["block_size"] * SERVE_GEOM["max_blocks_per_seq"]
    print(f"[serve] paged against dense decode, GPT-2 124M, prompt of {len(prompts[8])} tokens "
          f"and {SERVE_PAGED_STEPS} greedy steps at {slots:,} slots: {held}; on {card}",
          flush=True)
    prefix = torch.randint(0, cfg.vocab_size, (SERVE_PREFIX,), generator=gen,
                           device=SERVE_DEVICE)
    shared_prompts = [torch.cat([prefix, torch.randint(
        0, cfg.vocab_size, (SERVE_SUFFIX * (1 + i % 8),), generator=gen, device=SERVE_DEVICE)])
        for i in range(len(SERVE_LENS))]
    shared_prompts += [shared_prompts[i] for i in SERVE_DUPLICATES]
    model32 = ServeModel.for_gpt2(tree_from_state_dict(gpt2_32), cfg32)
    plain, base, _, l1 = serve_run(model32, shared_prompts)
    shared, got, s_wall, l2 = serve_run(model32, shared_prompts, prefix_cache=True)
    counts += [l1, l2]
    differ = [i for i in base if got[i].tokens != base[i].tokens]
    if (differ or not shared.stats["prefix_hits"] or not shared.stats["cow_copies"]
            or shared.tables.pages_allocated >= plain.tables.pages_allocated):
        raise AssertionError(f"[serve] prefix cache: requests {differ} not token-identical to "
                             f"the unshared run, {shared.stats}, pages "
                             f"{shared.tables.pages_allocated} against "
                             f"{plain.tables.pages_allocated}")
    errs = []
    for i, p in enumerate(shared_prompts):
        seq = torch.cat([p, torch.tensor(base[i].tokens[:-1], device=SERVE_DEVICE)])[None]
        for kind, run in (("unshared", plain), ("shared", shared)):
            errs.append(f32_anchored(f"[serve] prefix-cache run, {kind} request {i}",
                                     run.logits_of(i), seq, None, gpt2_32, len(p) - 1)[0])
    gap = max(float((shared.logits_of(i) - plain.logits_of(i)).abs().max()) for i in base)
    print(f"[serve] --prefix_cache, GPT-2 124M at float32 compute, {len(shared_prompts)} prompts "
          f"sharing {SERVE_PREFIX} tokens (the last {len(SERVE_DUPLICATES)} repeat earlier ones "
          f"whole): "
          f"{len(base)} of {len(base)} completions token-identical to the unshared run; "
          f"max|shared - unshared| logit {gap:.3e}; max|engine - f32| over both runs "
          f"{max(errs):.3e} (bound F32_REL max|f32|, F32_REL = {F32_REL}); physical pages "
          f"allocated {shared.tables.pages_allocated} against {plain.tables.pages_allocated}; "
          f"prefix hits {shared.stats['prefix_hits']}, shared tokens "
          f"{shared.stats['shared_tokens']}, copy-on-write {shared.stats['cow_copies']}; "
          f"{len(base) * SERVE_NEW / s_wall:.1f} tokens/s; on {card}", flush=True)
    del plain, shared, model, model32, params, gpt2, gpt2_32
    gc.collect()   # a RecordingEngine and its hook's closure hold each other
    torch.cuda.empty_cache()
    counts.append(llama_serve_run(tmp, gen, card))
    gc.collect()
    torch.cuda.empty_cache()
    total = {k: sum(c[k] for c in counts) for k in KERNELS}
    if any(total.values()):
        raise AssertionError(f"[serve]: kernels launched {total}")
    return total


def phase_time(name: str, since: float) -> float:
    """Print the wall time of a phase that began at ``since``; returns now."""
    now = time.perf_counter()
    print(f"[phase] {name}: {now - since:.1f} s", flush=True)
    return now


def main():
    if sys.argv[1:2] == ["--resume-child"]:
        return resume_child(sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5:])
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    print(f"[card] {name}: {torch.__version__}, CUDA {torch.version.cuda}, data-sheet "
          f"bandwidth {rates[0] / 1e12:.2f} TB/s, bfloat16 {rates[1] / 1e12:.0f} TFLOP/s, "
          f"float32 {rates[2] / 1e12:.0f} TFLOP/s", flush=True)
    t = time.perf_counter()
    regs = build_cuda_kernels()
    t = phase_time("build", t)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rec, err = optimizer_kernel_phase(gen, rates)
    print(f"[card] Triton kernels built with triton {fused_lion.triton.__version__}", flush=True)
    t = phase_time("optimizer kernels", t)
    mixed = mixed_phase(gen, card)
    t = phase_time("[mixed], a mixed-dtype tree's step", t)
    for case in FLASH_CASES:
        frec, ferr = flash_kernel_phase(gen, rates, regs, *case)
        rec.update(frec)
        err.update(ferr)
        t = phase_time(f"flash kernels, head_dim {case[0]}", t)
    model_check()
    product_check(gen)
    nf4_check(gen)
    phase_time("model, products, NF4", t)
    with tempfile.TemporaryDirectory() as tmp:
        (world, wire, buckets), runs, llama, dpo, mode_times, llama3, xent, phases = slice_phase(
            tmp, gen, card, rates)
        t = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()   # the four ranks of the W4 phase share the card
        print(f"[card] before the W = {W4} phase this process holds "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)
        w4_phase(tmp, card)
        t = phase_time(f"slice (f), GPT-2 124M at W = {W4} on one card", t)
        ep_phase(tmp, card)
        t = phase_time(f"slice (y2), (y3), GPT-2-MoE at W = {W4} on one card", t)
        pp_launches = pp_phase(tmp, card)
        phase_time(f"slice (z1)-(z4), pipeline parallelism at W = {W4} on one card", t)
    for label, rs, counts in runs:
        step_ms = statistics.median(r["step_ms"] for r in rs[1:])
        tok_s = statistics.median(r["tokens_per_sec"] for r in rs[1:])
        print(f"[slice] {label}: GPT-2 124M, {world} rank, wire {wire}, {buckets} "
              f"bucket(s), losses {[round(r['loss'], 4) for r in rs]}: steps 2-{len(rs)} "
              f"{[r['step_ms'] for r in rs[1:]]} ms, median {step_ms:.1f} ms/step, "
              f"{tok_s:.0f} tokens/s on {card}; launches {counts}", flush=True)
    rows, llama_launches, peak, wall = llama
    print(f"[slice] (d) run_sft Llama-2-7B, NF4 base, LoRA q/v, flash hd128, B 4 x accum "
          f"{ACCUM} x T 1024, 1 rank: losses {[round(r['loss'], 4) for r in rows]}: steps "
          f"2-{STEPS} {[r['step_ms'] for r in rows[1:]]} ms, median "
          f"{statistics.median(r['step_ms'] for r in rows[1:]):.1f} ms/step, "
          f"{statistics.median(r['tokens_per_sec'] for r in rows[1:]):.0f} tokens/s; peak "
          f"device memory {peak / 2**30:.2f} GiB; run_sft.main {wall:.1f} s on {card}; "
          f"launches {llama_launches}", flush=True)
    rows, dpo_launches, peak, wall, ev = dpo
    print(f"[slice] (j) run_dpo Llama-2-7B, dense float32 policy base, NF4 reference, LoRA on "
          f"the DPO targets ({N_DPO:,} coordinates), flash hd128, telemetry, B {DPO_PAIRS} pairs "
          f"x accum {ACCUM} x T 1024, 1 rank: losses {[round(r['loss'], 4) for r in rows]}: "
          f"steps 2-{STEPS} {[r['step_ms'] for r in rows[1:]]} ms, median "
          f"{statistics.median(r['step_ms'] for r in rows[1:]):.1f} ms/step, "
          f"{statistics.median(r['tokens_per_sec'] for r in rows[1:]):.0f} tokens/s (pairs x T, "
          f"as the JAX trainer counts); reward_margin by step "
          f"{[round(r['reward_margin'], 5) for r in rows]}; eval {ev}; peak device memory "
          f"{peak / 2**30:.2f} GiB; run_dpo.main {wall:.1f} s on {card}; launches {dpo_launches}",
          flush=True)
    rows, k_launches, peak, wall, opt_ms, opt_bound = llama3
    print(f"[slice] (k) run_clm Llama-3-8B full-parameter, {N_LLAMA3:,} bfloat16 params, "
          f"--vocab_chunks {XENT_CHUNKS}, flash hd128 by auto, B 1 x accum {K_ACCUM} x T {K_T}, "
          f"1 rank: losses {[round(r['loss'], 4) for r in rows]}: steps 2-{K_STEPS} "
          f"{[r['step_ms'] for r in rows[1:]]} ms, median "
          f"{statistics.median(r['step_ms'] for r in rows[1:]):.1f} ms/step, "
          f"{statistics.median(r['tokens_per_sec'] for r in rows[1:]):.0f} tokens/s; peak "
          f"device memory {peak / 2**30:.2f} GiB; optimizer step {opt_ms:.4f} ms (bound "
          f"{opt_bound:.4f}); run_clm.main {wall:.1f} s on {card}; launches {k_launches}",
          flush=True)
    print(f"[xent] on {card}: " + json.dumps(xent), flush=True)
    print("[modes] optimizer step device time at n=124,439,808 on " + card + ": "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in mode_times.items()), flush=True)
    # each main path's counts: GPT-2's (b) for the optimizer and hd64 flash
    # kernels, (h2)'s for the bf16-momentum instantiations, (k)'s for the
    # all-bfloat16 ones, Llama's (d) for the hd128 ones
    h2 = next(counts for label, _, counts in runs if label.startswith("(h2)"))
    launches = dict(runs[1][2], **{k: llama_launches[k] for k in NO_HD128},
                    **{f"{k}_mom_bf16": h2[k] for k in ("fused_ballots", "fused_apply")},
                    **{f"{k}_p_bf16": k_launches[k] for k in ("fused_ballots", "fused_apply")})

    kernels = []
    for k in KERNELS:
        route, source, replaces = ROUTES[k]
        ms, plain_ms, bms, by, library = rec[k]
        kernels.append({"name": k, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[k], "max_abs_err": err[k], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                        "library_ms": library, "pipeline_launches": pp_launches[k],
                        "chunk_launches": phases["chunk"][k],
                        "generate_launches": phases["generate"][k],
                        "serve_launches": phases["serve"][k], "mixed_launches": mixed[k]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
