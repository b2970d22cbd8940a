#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with one card:  python3 chip_smoke.py

Phases, each of which must pass (exit 1 otherwise):

1. build    prints the card (name, power limit), torch / CUDA / nvcc versions,
            turns TF32 off for the plain versions (cuDNN's convolutions
            default to it) and builds the CUDA kernels from the sources, one
            nvcc per library, all started together (mbconv.cu and fusedmb.cu
            twice: fp32 and bf16 storage), each with -Xptxas -v, whose
            registers, shared memory and spills per kernel are printed for
            the MBConv, Fused-MBConv, separable and conv1d libraries, and
            each nvcc's seconds (conv1d.cu's on a line of its own); then the HMMA
            (tensor-core product) instructions per kernel in both mbconv
            and both fusedmb builds' and the separable library's SASS
            (cuobjdump -sass): the bf16 builds' pass 1, recompute, retain
            and Fused-MBConv kernel and the separable library's
            fused_separable_mma must have them, the fp32 builds and the
            fp32 fused_separable_kernel none.
2. kernels  full-width EfficientNet-B0, batch 8, at every serve bucket
            (224, 384, 512): on every block, with the tiles and modes the
            engine solves for that bucket, each MBConv kernel (pass 1 with
            and without the DW write, its folded SE pool exactly the
            tile-order sum of its partials, pass 2 recompute at the tile a
            recompute pin solves with its c_out tiles and C_mid splits, and
            retain, both of which must repeat bit for bit, and, where
            either launch splits C_mid, its folded split-K sum (B3')
            exactly the split-order sum of the partials the same launch
            wrote),
            with the block's activation and SE, against its plain
            PyTorch version on the same inputs on the card, within
            1e-4 * max|plain| + 1e-5.  At 224 each is also timed: device
            time of 20 calls replayed from one CUDA graph (kernel, plain
            version, and the one-call library version where PyTorch has
            one), and the kernel's host-inclusive time of 20 eager calls,
            both on CUDA events; then per block the two pass-2 routes side
            by side (pass 1 + recompute against pass 1 with the DW write +
            retain, each with its folded split sum).  B2's and B3's
            bound_ms count the function's own bytes and operations; a
            split launch's row also carries bound_split_ms, with its
            partials written and read back and its adds (per-block rows
            only, not the kernels line).  At 224 the bf16 builds
            too (rows <kernel>_bf16), at the bf16 forward's tiles, on the
            same inputs rounded to bf16 (the gate fp32): pass 1's retained
            DW and each pass 2's output within 1 bf16
            ulp of the plain version's fp32 result on the same bf16 values
            (elements near 0 of long sums, where two fp32 summation orders
            alone differ by more than that ulp, within the fp32 bar
            instead; their count printed), a split pass 2's output
            exactly its fp32 partials' split-order sum rounded once, pass
            1's fp32 pool partials at
            the fp32 bar and its pool exactly their tile-order sum, timed
            as the fp32 rows, bound_ms with 2 bytes a stored element and
            the GEMM-shaped products (expand, projection) at the bf16
            tensor-core rate, the depthwise and elementwise work at fp32's.
3. model    full-width B0 (1000 classes) at 224, batch 8, from a seeded
            torch.Generator: the logits on the card against the same model on
            the CPU through the plain versions, within 1e-3 relative; then the
            forward timed on CUDA events.
4. trace    the B0 forward traced with torch.profiler (device time by
            kernel, busy share).
5. serve    the B0 main path: VisionEngine at buckets (224, 384, 512), batch
            8, answering 12 mixed requests (one oversize, shed).  Launch
            counts are zeroed just before and read just after; every MBConv
            kernel must have run, and no SE pool reduce (folded into pass
            1).  Each bucket's schedules are built once,
            and a padded request of the 384 and of the 512 bucket match the
            CPU plain run of its padded image within 1e-3 relative.
6. v2s-kernels  full-width EfficientNet-V2-S at 384x384, batch 8, with the
            solved tiles: the Fused-MBConv kernel against its plain version
            on each of the 10 fused blocks (and bit for bit on a second
            call), and every MBConv kernel on each of the 30 MBConv blocks,
            at the same bar.  The kernels each block runs are timed as in
            phase 2.  The bf16 builds too, at the bf16 forward's tiles, at
            phase 2's bf16 bar: the Fused-MBConv kernel (conv and
            projection on bf16 tensor cores) on each fused block, bit for
            bit on a second call, timed beside the fp32 build (both in the
            kernels line's fusedmb_bf16 entry, with the bound counting the
            exact split's three projection products), and every MBConv
            kernel on each MBConv block (the deep tensor-core GEMMs),
            retain and recompute bit for bit on a second call; the on-path
            ones timed, retain beside its bf16 einsum.
7. v2s-model    the V2-S main path: full-width V2-S at 384, batch 8, on the
            card, launch counts zeroed just before and read just after
            (exactly 10 Fused-MBConv launches, one per fused block); the
            first 2 images' logits against the CPU plain run within 1e-3
            relative; the forward timed on CUDA events and traced.
8. v3-kernels   full-width MobileNet-V3-Large at 224, batch 8, with the
            solved tiles: every MBConv kernel on each of the 15 blocks with
            the block's activation (relu or hard_swish) and, on the 8 SE
            blocks, a hard_sigmoid gate (the others run without partials,
            pool or gate), at the same bar, each timed as in phase 2 with
            the two pass-2 routes side by side; and in bf16 at the bf16
            forward's tiles as in phase 2 (ragged C_mid 72, 120, 184, 200
            for the tensor cores' k16 steps), timed.
9. v3-model     the V3 main path: full-width MobileNet-V3-Large at 224,
            batch 8, on the card, launch counts zeroed just before and read
            just after (one pass 1 on each SE or retain block), against the
            CPU plain run within 1e-3 relative; the forward timed on CUDA
            events and traced.
10. bf16-model  B0 224, MobileNet-V3-Large 224 and V2-S 384 at batch 8 with
            their configs' dtype "bfloat16", the fp32 phases' seeded
            weights and images: launch counts zeroed just before and read
            just after (the bf16 main paths: no fp32 MBConv or Fused-MBConv
            launch, exactly 10 bf16 Fused-MBConv launches in V2-S); B0's
            and V3's first 2 images' bf16 logits within 2e-2 x max|ref| of
            the CPU plain bf16 forward; V2-S block by block (each block on
            the card's bf16 activation against kernels.ref's oracle on the
            same bf16 values, within 2e-2 x max|ref|); each forward timed
            on CUDA events and traced, printed beside its fp32 forward.
11. paper       the paper's dataflow: (a) the executable ConvDK twin
            (repro_torch.core.convdk) at full width on the card against its
            grouped-conv oracle (MobileNet-V2's two depthwise layers of
            largest map, a k=5 s=2 layer of B0), within the phase-2 bar;
            (b) every block of B0 224, MobileNet-V3-Large 224 and V2-S 384,
            batch 8, fused and staged (the depthwise kernel over staged
            strips, cuBLAS / cuDNN for the rest) on the same fp32 inputs and
            weights, each and each other within 1e-4 of max|oracle|
            (kernels.ref), and the depthwise kernel against its plain
            version at each staged MBConv block's shape (the phase-2 bar),
            timed warm (20 calls replayed from one CUDA graph)
            and cold (a 128 MiB scratch write between 5 graph replays,
            outside the timed window), beside the modeled bytes and the
            staged working set against the 50 MB L2, with the peak memory
            per network; (c) each of the three forwards fused and staged:
            logits within 1e-3 relative, the staged route's launches counted
            (one depthwise per MBConv block, nothing else), each route timed
            on CUDA events and traced; (d) the CIM model's Figs. 7-8
            (host arithmetic) beside the paper's bands, the WS
            buffer-traffic reduction inside its band.  Speed never fails it.
12. bench       the port's measurement record: the per-block sweep
            (kernel_bench.measure_sweep: every block of B0 224, V3 224 and
            V2-S 384 at batch 8, each schedule point of the sweep checked
            against the oracle within 1e-4 x max|oracle|, then timed from
            CUDA graph replays) written as build/chip_smoke/BENCH_<host>.json,
            checked by validate_bench and diffed against the committed
            baseline results/bench_torch/BENCH_*.json (modeled bytes and
            axes must match; wall time gated only between comparable
            hosts); the calibration fit and rank agreement
            (roofline_bench.calibration_report); per block the Hopper
            model's device-memory and global bytes of the fused route and
            the staged model's bytes beside the paper phase's fused and
            staged ms, with the blocks where the model's sign and the
            card's agree, warm and cold; then serve_report at (224, 384,
            512) through VisionEngine (2 warm batches per bucket left out,
            then 400 requests on a Poisson schedule at 0.5 per mean warm
            batch time, latency from arrival), its gate passing, with the
            MBConv kernels' launches counted (zeroed just before, read just
            after).
13. sep-kernels the 17 full-width MobileNet-V2 separable blocks at 224,
            batch 8, and the trainer's 3 blocks at its batch 32, with the
            solved tiles and C_in splits: the fused separable kernel (one
            launch, its split sum B4' folded in where the block splits,
            that output exactly act of the split-order sum of the
            partials the same launch wrote; dw_act relu, act relu and
            None, relu6 on one block; bit for bit on a second call) and
            the depthwise kernel over the staged
            strips of the padded input, each against its plain version at
            the phase-2 bar, timed as in phase 2 (a split fused row also
            carries bound_split_ms, as in phase 2; the depthwise
            kernel also beside F.conv2d(groups=C)
            on the unstaged input); the depthwise kernel in bf16
            (dw2d_bf16, at the launch shape dw2d_bf16_plan solves, printed)
            on the trainer's blocks and on the 17 blocks (the fp32 rows'
            strips) bit for bit the fp32 kernel's output on the widened
            values rounded once and within 1 bf16 ulp of the fp32 sum
            rounded once, timed beside bf16 F.conv2d(groups=C); the fused
            separable kernel in bf16
            (fp32 sums, the pointwise on tensor cores, the C_in splits a
            cluster) on the 17 blocks at their bf16 schedules, within 1
            bf16 ulp of the plain version's fp32 result on the same bf16
            values (near 0 the fp32 bar), bit for bit on a second call and
            on graph replays, a split block's output exactly act of the
            split-order sum of its own fp32 rank products rounded once,
            timed (entry fused_separable_bf16, bound at 2 bytes a stored
            element, the pointwise products at the tensor cores' rate);
            then the 17 blocks through
            separable_block, counts zeroed just before and read just
            after: exactly 17 fused separable launches and no reduce
            launch; again in bf16: exactly 17 fused_separable_bf16
            launches; and in bf16 on the staged route
            (separable_block(..., fused=False)): exactly 17 dw2d_bf16
            launches and no other, every output finite bf16 and within
            the JAX suite's bf16 bar (rtol = atol = 2e-2) of the same route
            on the CPU on the same bf16 values.
14. grad        on the card, each op's input and weight gradients (fused
            separable and depthwise at a MobileNet-V2 block, MBConv retain
            and recompute with SE at a B0 block, MBConv without SE at a V3
            block, Fused-MBConv at a V2-S block) against autograd through
            its plain version on the card, within 1e-4 * max|plain grad| +
            1e-5 per tensor; then the cross-entropy gradient of every
            parameter of full-width B0 (1000 classes, 224, batch 2, seeded
            weights and labels) against the CPU plain run, within 1e-3 *
            max|cpu grad| per leaf; then B0 forward + backward at batch 8
            timed on CUDA events and traced.
15. train       the separable training path, under deterministic
            algorithms (cuDNN deterministic, no cuDNN benchmark,
            torch.use_deterministic_algorithms, CUBLAS_WORKSPACE_CONFIG set
            before torch is imported; the first two restored after the
            phase): the trainer (repro_torch.examples.train_mobilenet_cim)
            on the card for 60 fused steps twice, with exactly 3 fused
            separable launches (its blocks never split C_in) and no
            depthwise launch per step, the two runs' losses bit for
            bit equal; then 30 --staged steps with exactly 3 depthwise
            launches and no fused one per step (counts zeroed just before
            each run, read just after); every loss of steps 1-30 of the
            fused and the staged runs within 1e-3 relative of a 30-step
            CPU plain run of the trainer, and step 1 within 1e-5 of it and
            of each other.  The fused run's DESCENDED/check verdict and
            step-60 ratio are printed: a single step of the chaotic lr 0.5
            trajectory is not a check of the code.
16. lm-kernels  the causal conv1d kernel on each conv of a Mamba-2 2.7B
            layer (D 5120, 128, 128; k 4; SiLU; bias) at batch 1 x 32768
            tokens, in bf16 (within 1 bf16 ulp of the plain version's
            fp32 sum rounded once) and in fp32 (the phase-2 bar), and in
            both bit for bit the plain version, timed as in phase 2 beside
            grouped F.conv1d + F.silu; each conv's launch plan (CTAs,
            waves, walk; its bytes requested ahead, modelled), the resident
            CTAs per SM of its instance (at least the plan's 4) and its
            share of the bound printed.
17. lm-model    full-width Mamba-2 2.7B (64 layers, seeded fp32 weights,
            materialized once and timed): the prefill forward with the
            kernel (exactly 192 conv1d launches, 3 per layer) and without it
            (none), counts zeroed just before and read just after; in fp32
            at batch 2 x 2048 the kernel path's logits against the plain
            path's within 1e-3 relative; a 2-layer full-width copy at 2 x 256
            against the CPU plain run within 1e-3 relative; then the bf16
            prefill step at 1 x 32768 (the main path of the conv1d kernel)
            timed on CUDA events and traced.
18. lm-serve    the LM engine at full width in bf16: generate_many on 7
            mixed requests (prompts of 12, 20, 28, 30, 40, 60 and 80
            tokens, 16 new tokens each, LITTLE below 64: two LITTLE packs
            and one BIG prompt), every one answered, with prefill
            tokens/s and decode ms per token; then
            in fp32 the engine's decode-loop prefill of 2 prompts of 32
            tokens against the kernel path's forward (last row) within
            1e-3 relative.
19. lm-train    the LM training step on the same full-width Mamba-2 tree:
            in fp32 at 1 x 2048 tokens of the synthetic stream
            (data.pipeline), two make_train_step steps (AdamW, remat) on
            the kernel route (exactly 384 conv1d launches a step: 3 per
            layer in the forward and again in the recompute) and two on the
            plain route (none), each from its own copy of the weights: the
            losses and grad norms within 1e-4 relative, and the parameter
            deltas (after - before) of the kernel route against the plain
            route's within 1e-4 x max|plain delta|; whether a second
            kernel-route run repeats the losses bit for bit is printed
            (where it does not, the embedding's backward is checked for
            repeating by itself).  Then launch.train.Trainer.run in bf16
            (fp32 params and AdamW state; its materialize timed) at 2 x
            2048 for 3 steps, no checkpoint, counts zeroed just before and
            read just after (384 a step): each step's loss, lr and grad
            norm, finite losses, step ms on CUDA events (mean of steps 2-3),
            tokens/s, peak memory, a trace of the step and the optimizer's
            update timed alone on CUDA events (its share of a step).  Then,
            under deterministic algorithms, a full-width 2-layer Trainer at
            2 x 512: 2 steps, a checkpoint saved under build/chip_smoke/,
            restored in a fresh Trainer and run to step 4, equal bit for
            bit (losses, params, optimizer state) to 4 straight steps; the
            checkpoint's bytes and its save and restore seconds printed.
20. dense-model full-width Gemma-2B (18 layers, d_model 2048, 8 query
            heads over 1 KV head of 256, GeGLU 16384, the tied
            256000-word table; seeded fp32 weights, materialized once
            after the Mamba-2 tree is freed, timed, its parameter count
            equal to the definition's): in fp32 at 1 x 4096 tokens, past
            q_chunk 2048, the forward through the chunked online softmax
            against the same forward with dense scores within 1e-3
            relative; a 2-layer full-width copy at 2 x 256 against the
            CPU run within 1e-3 relative; then the bf16 prefill step at
            1 x 4096 timed on CUDA events (tokens/s, peak memory) and
            traced.  No kernel of B1-B7 is on this path: every launch
            count is 0 around the forward and the prefill step.
21. dense-serve the LM engine on full-width Gemma-2B in bf16: generate_many
            on the lm-serve phase's 7 requests, 16 new tokens each, every
            one answered, no kernel launch, with prefill tokens/s and
            decode ms per token; then in fp32 the engine's decode-loop
            prefill of 2 prompts of 32 tokens against the forward (last
            row) within 1e-3 relative.
22. rg-kernels  the causal conv1d kernel without an activation on
            RecurrentGemma-9B's temporal conv (D 4096, k 4, bias) at batch
            1 x 4096 tokens, in bf16 (within 1 bf16 ulp of the plain
            version's fp32 sum rounded once) and in fp32 (the phase-2
            bar), bit for bit in both, timed as in phase 2 beside grouped
            F.conv1d, its plan printed as in lm-kernels.
23. rg-model    full-width RecurrentGemma-9B (38 layers: 26 RG-LRU and 12
            local attention over 2048 positions, 12 (R, R, A) blocks and an
            (R, R) remainder; seeded fp32 weights, materialized once after
            the Gemma tree is freed, timed, 9,396,195,328 parameters, equal
            to the definition's): in fp32 at 1 x 4096 tokens, past the
            window and q_chunk 2048, the kernel route (exactly 26 conv1d
            launches, one per RG-LRU layer, nothing else) against the
            plain route (none) and the chunked online softmax against
            dense scores, each within 1e-3 relative; a 3-layer (R, R, A)
            full-width copy at 2 x 256 against the CPU run within 1e-3
            relative; then the bf16 prefill step at 1 x 4096 (26 launches)
            timed on CUDA events (tokens/s, peak memory) and traced.
24. rg-serve    the LM engine on full-width RecurrentGemma-9B in bf16:
            generate_many on 4 LITTLE prompts (12, 24, 40 and 60 tokens,
            8 new tokens each), every one answered, no kernel launch (the
            decode step takes the plain conv update, as in JAX), with
            prefill tokens/s and decode ms per token; the fp32 decode-loop
            prefill of 2 x 32 tokens against the forward (last row); then
            in fp32 on the 3-layer copy with the window cut to 64 (reduced
            from 2048 so that the 64-slot ring cache wraps), every decode
            step's logits over 2 x 96 tokens against the forward's rows
            within 1e-3 relative.
25. moe-model   full-width Granite-MoE 3B-A800M (all 32 layers, 40
            experts padded to 48, top-8, seeded fp32 weights drawn on the
            card, 3,903,166,464 parameters, equal to the definition's): a
            2-layer full-width copy at 2 x 256 against the CPU run by the
            routing rule below; the fp32 forward at 1 x 4096 twice, equal
            bit for bit (logits and every layer's choices), the pairs
            dropped at capacity_factor 1.25 printed per layer; then the
            bf16 prefill step at 1 x 4096 timed on CUDA events (tokens/s,
            peak memory, its drops per layer) and traced.  No kernel of
            B1-B7 launches on the MoE path (JAX's is XLA).
            The routing rule: the card and the CPU (or two attention
            routes) may resolve a router near-tie between the k-th and
            (k+1)-th expert differently, and that token then takes another
            expert's output.  So a MoE comparison first compares every
            layer's top-k choices (models.moe.route_flips) and prints how
            many tokens differ, with the first one's probability gap.
            Where none differs, the logits are held to 1e-3 relative.
            Where some differ, the first flip (in flat B x S order, in its
            earliest layer) must be a near tie, a gap in the reference's
            probabilities under 1e-4, and the logits of the tokens before
            it, which route alike in every layer (a capacity and a causal
            attention pass a flip only to later tokens), are held to 1e-3
            relative.  No other bar is loosened for it.
26. moe-serve   the LM engine on full-width Granite-MoE in bf16:
            generate_many on 4 LITTLE prompts (12, 24, 40 and 60 tokens,
            16 new tokens each), every one answered, no kernel launch, with
            prefill tokens/s, decode ms per token and tokens/s; the fp32
            decode-loop prefill of 2 x 32 tokens against the forward (last
            row), both at capacity_factor 8, where neither drops (the JAX
            tests' convention).
27. mla-model   DeepSeek-V2 236B at full width and reduced depth: 2 of its
            60 layers (the dense-prefix layer and one MoE layer of 160
            routed experts at top-6 and 2 shared; MLA at 128 heads,
            q_lora 1536, kv_lora 512), 5,358,679,040 parameters, 21.4 GB
            in fp32 (the 60 layers, about 3.97 B parameters a MoE layer,
            do not fit 80 GB): in fp32 the model at 2 x 256 against the
            CPU run by the routing rule; at 1 x 4096 the chunked online
            softmax (q_chunk 2048) against dense scores by the routing
            rule; the decode loop over 2 x 32 tokens, absorbed and
            expanded, against the forward's rows and against each other
            within 1e-3 relative (capacity_factor 8); then the bf16 prefill
            step at 1 x 4096 timed on CUDA events and traced.
28. mesh        the sharded wrappers and the network plan over
            torch.distributed, parity runs (one H100 has no model axis):
            first a one-rank NCCL mesh (1, 1) runs full-width B0 at 224,
            batch 8, through the sharded path of every block, its logits
            equal to the unsharded fused forward's bit for bit with the
            same kernel launches; then, for the meshes (1, 2) and (2, 1),
            two ranks spawned on the one card over gloo (the kernels built
            above, before the spawn) run full-width B0 224 b8,
            MobileNet-V3-Large 224 b8, V2-S 384 b8 and the 17 MobileNet-V2
            separable blocks at 224 b8 (through separable_block's mesh
            route, the sharded separable wrapper under it), each
            gathered to its global result and held to the single-device
            fused result within 1e-4 x max|ref|: every block of each
            network on the single-device activation it takes (its plan's
            schedule, layouts and counted words), the separable blocks, and
            the B0 and V3 logits; at (2, 1), where each rank runs a batch-4
            half, every network's logits are also held to the single card's
            two batch-4 halves.  V2-S's logits amplify the order of fp32
            sums to percents at full width (printed: the card's fused batch
            8, its halves and its staged forward, each against the plain
            forward on the CPU), so at (1, 2) they are printed beside the
            single card's own spread, not gated.  Every rank's counted
            model-axis collectives per forward equal the words the network
            plan prices (none for the separable blocks).  At (1, 2) one
            full-width RecurrentGemma-9B attention layer (16 query heads
            over one KV head of 256, window 2048, seq_shard_attn) at 1 x
            4096 in fp32 takes the sequence-parallel route (each rank its
            2048 query rows against the whole K/V, one all-gather of the
            output over "model"), held to the unsharded layer within
            1e-4 x max|ref|, and one full-width Granite-MoE layer (48
            experts, top-8, 1 x 4096 tokens, fp32) runs expert-parallel
            (each rank 24 experts, one counted all-reduce of the output
            over "model"), held to the single card within 1e-4 x max|ref|.
            It prints each
            rank's forward ms (a parity run's time, not a speed) and the
            transport gloo used for each collective of CUDA tensors and
            dtype (native or through the host, the host calls counted).
            Then, on the same two ranks, in bf16: B0 with dtype bfloat16
            block by block on its plan at 2-byte words and its logits, and
            the 17 separable blocks in bf16, each held to the single card's
            bf16 result within 2e-2 x max|ref|, the counted model-axis
            words equal to the plan's (the bf16 cases' seconds printed).
            Then the backward on the same two ranks: full-width B0 224 b8
            forward and backward through the mesh, fp32 and again with
            dtype bfloat16, the trainer's cross-entropy at labels from a
            seeded generator, every parameter's gradient summed over the
            batch axes (launch.mesh.sum_batch_grads) and held to the single
            card's loss.backward() at the same weights within 1e-4 (bf16:
            2e-2) x |grad| + the same x max|grad| over the tree, each leaf's
            error at its own scale reported beside it, with each rank's
            forward + backward ms (a parity run's time) and the card's name
            and power limit; at (1, 2) a bf16 MBConv wrapper case forced
            to the psum_scatter exit (B0 block 1's shape), held to the
            unsharded op within 2e-2 x max|ref|, passing where gloo ran
            its bf16 reduce-scatter of CUDA tensors natively or through
            the host with Mesh.host_calls counting it (which one printed);
            and tears torch.distributed down.

The line before the last is {"kernels": [...]} (the SE pool reduce listed
as folded into pass 1, the split-K sums B3' and B4' as folded into retain
and recompute and into the fused separable kernel: no launches, no time of
their own; the bf16 builds of B1-B3' and B5 and B4's bf16 instantiation
as entries <kernel>_bf16 of their own); no forward launches a folded sum.  The last line is
{"ok": true, "device": {...}}.  Per-block kernel numbers are also written to
build/chip_smoke/kernels.json.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

# cuBLAS's deterministic workspace for the train phase's pinned run: read
# when cuBLAS first initialises, so set before torch is imported
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5      # x max|plain|, absolute
MODEL_RTOL = 1e-3                          # x max|cpu logits|
BATCH, RES = 8, 224
SERVE_RES = (224, 384, 512)                # the serve phase's buckets
V2S_RES, V2S_CPU_IMAGES = 384, 2           # V2-S eval size; images on CPU
V3_RES = 224
MNV2_RES = 224                             # MobileNet-V2's published size
TRAIN_STEPS, STAGED_STEPS = 60, 30         # the trainer's fused / staged runs
TRAIN_CPU_STEPS, TRAIN_RTOL = 30, 1e-3     # card vs CPU plain run, per step
GRAD_RTOL = 1e-3                           # x max|cpu grad|, per leaf
GRAD_CPU_IMAGES = 2                        # B0 gradient images vs the CPU
LM_TOKENS = 32768                          # the bf16 prefill: 1 x 32768
LM_CHECK = (2, 2048)                       # fp32 kernel vs plain path
LM_CPU = (2, 256)                          # 2-layer copy vs the CPU
LM_CONVS = (("conv_x", 5120), ("conv_b", 128), ("conv_c", 128))
# lm-serve's prompt lengths: LITTLE below LM_LITTLE in buckets of 32, one BIG
# (two BIG prompts of 300 tokens with LITTLE below 256 did not leave the
# RecurrentGemma phases room in the time limit)
LM_REQUESTS = (12, 20, 28, 30, 40, 60, 80)
LM_LITTLE = 64
LM_NEW_TOKENS = 16
LM_TRAIN_CHECK = (1, 2048)                 # lm-train fp32 parity: B x tokens
LM_TRAIN_BATCH = (2, 2048)                 # lm-train bf16 Trainer.run
LM_TRAIN_STEPS = 3
LM_RESUME = (2, 2, 512)                    # resume: layers, B, tokens
LM_DELTA_RTOL = 1e-4                       # x max|plain route's delta|
LM_BF16_ROUTE_RTOL = 1e-3                  # bf16 kernel vs its plain version
LM_TRAIN_OPTIM = {"peak_lr": 3e-4, "warmup_steps": 2, "decay_steps": 100}
DENSE_TOKENS = 4096                        # dense-model: past q_chunk 2048
DENSE_CPU = (2, 256)                       # 2-layer Gemma copy vs the CPU
RG_TOKENS = 4096                           # rg-model: past window, q_chunk
RG_PARAMS = 9_396_195_328                  # RecurrentGemma-9B, the definition
RG_REQUESTS = (12, 24, 40, 60)             # rg-serve: one LITTLE pack
RG_NEW_TOKENS = 8
RG_WRAP = (2, 96, 64)                      # rg-serve fp32: B, tokens, window
MOE_TOKENS = 4096                          # moe-/mla-model: 1 x 4096 tokens
MOE_PARAMS = 3_903_166_464                 # Granite-MoE 3B-A800M's definition
MOE_REQUESTS = (12, 24, 40, 60)            # moe-serve: one LITTLE pack
MOE_NEW_TOKENS = 16
MLA_LAYERS = 2                             # DeepSeek-V2: prefix + 1 MoE layer
MLA_PARAMS = 5_358_679_040                 # ... those 2 layers, the definition
MLA_DECODE = (2, 32)                       # mla-model's decode loop: B, tokens
NEAR_TIE = 1e-4                            # the routing rule's probability gap
MESH_SHAPES = ((1, 2), (2, 1))             # the mesh phase's two-rank meshes
MESH_RTOL = 1e-4                           # x max|single-device result|
BF16_RTOL = 2e-2                           # x max|ref|: the JAX bf16 bar
BF16_ATOL = 2e-2                           # the JAX suite's absolute bf16 bar
BF16_CPU_IMAGES = 2                        # bf16 logits held to the CPU
DEVICE = "cuda"
def _separable_bf16_check(torch, tfs, stats, hx, res, i, b, h, w, c, c_out,
                          k, s):
    """The fused separable kernel in bf16 (x, taps, w_pw and output; fp32
    sums; the pointwise on tensor cores, the C_in splits a cluster) on one
    block at its bf16 schedule: within 1 bf16 ulp of the plain version's
    fp32 result on the same bf16 values (``_bf16_verdict``), bit for bit on
    a second launch (with no partial tensor) and on replays of a captured
    CUDA graph, and where the launch splits C_in its output exactly act of
    the split-order sum of the fp32 rank products it stored, rounded once;
    timed beside the plain version (no PyTorch call computes the block).
    Its bound prices the pointwise products at the tensor cores' rate and
    the depthwise at fp32's; ``bound_split_ms`` adds the split's mid and lo
    products and the cluster's fold adds."""
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.kernels.convdk_mbconv import MBConvGeometry

    sch = get_fused_schedule(b, h, w, c, c_out, k, s, dtype_bytes=2)
    geo = MBConvGeometry.make(h, w, k, s, "SAME", sch.tile_h, sch.tile_w)
    oh, ow = geo.out_h, geo.out_w
    x = hx.rand(b, h, w, c).bfloat16()
    w_dw = hx.rand(k, k, c, scale=1.0 / k).bfloat16()
    w_pw = hx.rand(c, c_out, scale=c ** -0.5).bfloat16()
    kw = dict(dw_act="relu", act="relu")
    got, part = tfs.fused_separable_with_partials(x, w_dw, w_pw, geo, **kw)
    good, err, bar, ulps, past = _bf16_verdict(
        got, tfs.fused_separable_plain(x.float(), w_dw.float(), w_pw.float(),
                                       geo, **kw))
    again = torch.equal(got, tfs.fused_separable(x, w_dw, w_pw, geo, **kw))
    exact = part is None or torch.equal(got, tfs.fused_separable_reduce_plain(
        part, act="relu", dtype=torch.bfloat16))
    replays = DEVICE != "cuda" or _graph_replays_equal(
        torch, lambda: tfs.fused_separable(x, w_dw, w_pw, geo, **kw), got)
    count = b * oh * ow * c_out
    nbytes = 2 * (b * h * w * c + k * k * c + c * c_out + count)
    flops = 2 * b * oh * ow * k * k * c             # the depthwise, fp32
    mma_flops = 2 * count * c                        # the pointwise products
    # the exact split's mid and lo products and the fold's adds
    split_ms = _bound(nbytes, flops + (sch.splits - 1) * count,
                      3 * mma_flops)[0]
    good_all = good and again and exact and replays
    ok = stats.add(
        "fused_separable_bf16", "mnv2_bf16", res, i, True, err, bar,
        hx.times(True, lambda: tfs.fused_separable(x, w_dw, w_pw, geo, **kw),
                 lambda: tfs.fused_separable_plain(x, w_dw, w_pw, geo,
                                                   **kw)),
        nbytes, flops, good=good_all, mma_flops=mma_flops, bf16_ulps=ulps,
        past_one_ulp=past, dtype="bfloat16", h=h, w=w, c_in=c,
        c_out=c_out, k=k, s=s, batch=b,
        tile=f"{geo.tile_h}x{geo.tile_w}", co_tile=sch.co_tile,
        splits=sch.splits, bound_split_ms=split_ms)
    print(f"  mnv2 bf16 block{i:02d} fused_separable_bf16: worst {ulps:.3f} "
          f"bf16 ulp, {past} past 1 ulp; c_out tile {sch.co_tile}, a "
          f"cluster of {sch.splits}"
          f"{', output exactly act of the rank-order sum of its products' if part is not None and exact else ''}"
          f"{', NOT the sum of its products' if not exact else ''}; "
          f"{'repeats' if again else 'does NOT repeat'} bit for bit, "
          f"graph replays {'equal' if replays else 'DIFFER'} "
          f"{'ok' if good_all else 'FAIL'}")
    _sync(torch)
    return ok


def _graph_replays_equal(torch, fn, want, replays=2):
    """``fn()`` captured in one CUDA graph (after a warm call on a side
    stream), its output equal to ``want`` bit for bit on every replay."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = fn()
    equal = True
    for _ in range(replays):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        equal &= torch.equal(out, want)
    return equal


REPLACES = {
    "mbconv_pass1": "src/repro/kernels/convdk_mbconv.py:118",
    "mbconv_pool_reduce": "src/repro/kernels/convdk_mbconv.py:151",
    "mbconv_pass2_recompute": "src/repro/kernels/convdk_mbconv.py:169",
    "mbconv_pass2_retain": "src/repro/kernels/convdk_mbconv.py:220",
    "mbconv_splitk_reduce": "src/repro/kernels/convdk_mbconv.py:245",
    "fusedmb": "src/repro/kernels/convdk_fusedmb.py:59",
    "fused_separable": "src/repro/kernels/convdk_fused.py:59",
    "fused_separable_bf16": "src/repro/kernels/convdk_fused.py:59",
    "fused_separable_reduce": "src/repro/kernels/convdk_fused.py:107",
    "dw2d": "src/repro/kernels/convdk_dw.py:32",
    "dw2d_bf16": "src/repro/kernels/convdk_dw.py:32",
    "conv1d": "src/repro/kernels/convdk_conv1d.py:27",
}
# the bf16 builds of the MBConv and Fused-MBConv kernels, entries of their
# own in the kernels line
BF16_KERNELS = ("mbconv_pass1", "mbconv_pass2_recompute",
                "mbconv_pass2_retain", "mbconv_splitk_reduce", "fusedmb")
REPLACES.update({f"{k}_bf16": REPLACES[k] for k in BF16_KERNELS})
# cross-CTA sums folded into their kernels' epilogues: kernels of the
# kernels line, never launched on their own
FOLDED = ("mbconv_pool_reduce", "mbconv_splitk_reduce",
          "mbconv_splitk_reduce_bf16", "fused_separable_reduce")
CSRC = "src/repro_torch/kernels/csrc"
SOURCES = {k: f"{CSRC}/{'fusedmb' if k.startswith('fusedmb') else 'mbconv'}.cu"
           for k in REPLACES}
SOURCES.update(fused_separable=f"{CSRC}/separable.cu",
               fused_separable_bf16=f"{CSRC}/separable.cu",
               fused_separable_reduce=f"{CSRC}/separable.cu",
               dw2d=f"{CSRC}/separable.cu", dw2d_bf16=f"{CSRC}/separable.cu",
               conv1d=f"{CSRC}/conv1d.cu")


def _bound(nbytes: float, flops: float, mma_flops: float = 0):
    """(bound, bytes term, operations term) in ms: ``flops`` at the fp32
    rate, ``mma_flops`` (bf16 products, exact in fp32 and summed there, as
    the bf16 builds compute them) at the tensor cores' (the H100 data
    sheet's peaks, ``core.telemetry.bound_ms``)."""
    from repro_torch.core.telemetry import bound_ms
    return bound_ms(nbytes, flops, mma_flops)


class KernelStats:
    """Every kernel check (one row per network, bucket, block and kernel
    variant), with times and bounds on the timed rows; sums over the blocks
    of a main path for the kernels line."""

    def __init__(self):
        self.rows = []

    def add(self, kernel, net, res, block, on_path, err, tol, times=None,
            nbytes=0, flops=0, good=None, mma_flops=0, **shape):
        """``good`` overrides the verdict ``err <= tol`` where the bar is
        not one absolute tolerance (bf16: 1 ulp per element);
        ``mma_flops`` are bf16 products, priced at the tensor cores' rate
        (``_bound``)."""
        good = err <= tol if good is None else good
        row = dict(kernel=kernel, net=net, res=res, block=block,
                   on_path=on_path, max_abs_err=err, tol=tol, **shape)
        line = (f"  {net} r{res} block{block:02d} {kernel:24s} err "
                f"{err:.3e} (tol {tol:.3e}) {'ok' if good else 'FAIL'}")
        if times is not None:
            bound_ms, bytes_ms, ops_ms = _bound(nbytes, flops, mma_flops)
            row.update(times, bound_ms=bound_ms, bound_bytes_ms=bytes_ms,
                       bound_ops_ms=ops_ms)
            line += "  " + "  ".join(
                f"{k} {v:.4f}" for k, v in times.items() if v is not None)
            line += f"  bound_ms {bound_ms:.4f}"
        self.rows.append(row)
        print(line + ("" if on_path else "  [off the main path]"))
        return good

    def sums(self, kernel, net, res):
        """Sums over the blocks of one network's main path at ``res`` (a
        time None where any block's is); None when the path runs no block
        of ``kernel``."""
        path = [r for r in self.rows if r["kernel"] == kernel
                and r["net"] == net and r["res"] == res and r["on_path"]]
        if not path:
            return 0, None
        by_bytes = sum(r["bound_bytes_ms"] for r in path)
        by_ops = sum(r["bound_ops_ms"] for r in path)

        def total(key):
            vals = [r[key] for r in path]
            return None if None in vals else sum(vals)

        return len(path), {
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": sum(r["bound_ms"] for r in path),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": total("library_ms"), "host_ms": total("host_ms"),
        }

    def conv1d_per_conv(self, net, res):
        """Per conv of ``net``'s main path at ``res`` (its bf16 rows), what
        the run measured: ms, its share of the bound, and the resident
        CTAs per SM the occupancy calculator gives the kernel's instance
        (the plans, modelled, stay in the rows of kernels.json)."""
        return {r["conv"]: {
            "ms": r["ms"], "share_of_bound": r["bound_ms"] / r["ms"],
            "resident_ctas_per_sm": r["resident_ctas"]}
            for r in self.rows if r["kernel"] == "conv1d"
            and r["net"] == net and r["res"] == res and r["on_path"]}

    def both_modes(self, net, res):
        """Per block of ``net`` at ``res``, the device ms of its two pass-2
        routes from the timed rows: pass 1 (where SE needs it) + recompute,
        against pass 1 with the DW write + retain (each with its folded
        split-K sum), and the solver's mode; printed and returned."""
        def ms(kernel, block, **match):
            rows = [r for r in self.rows if r["kernel"] == kernel
                    and r["net"] == net and r["res"] == res
                    and r["block"] == block and r.get("ms") is not None
                    and all(r.get(k) == v for k, v in match.items())]
            return rows[0]["ms"] if rows else None

        table = []
        for block in sorted({r["block"] for r in self.rows
                             if r["net"] == net and r["res"] == res}):
            b2 = ms("mbconv_pass2_recompute", block)
            b3 = ms("mbconv_pass2_retain", block)
            ret1 = ms("mbconv_pass1", block, retain=True)
            row = next(r for r in self.rows if r["net"] == net
                       and r["res"] == res and r["block"] == block)
            rec1 = ms("mbconv_pass1", block, retain=False) if row["se"] \
                else 0.0
            if None in (b2, b3, ret1, rec1):
                continue
            table.append(dict(block=block, mode=row["mode"],
                              recompute_ms=rec1 + b2, retain_ms=ret1 + b3))
            print(f"  {net} r{res} block{block:02d} pass 1 + recompute "
                  f"{rec1 + b2:.4f} ms, pass 1 + retain {ret1 + b3:.4f} ms "
                  f"(solved: {row['mode']})")
        return table

    def summary(self, launches):
        """The kernels line: each kernel over its main path (B0 serving for
        the MBConv kernels, the V2-S forward for Fused-MBConv, the trainer
        for the separable kernels, timed over the MobileNet-V2 blocks); the
        MBConv kernels also carry their launches, and their sums where the
        path runs them, over the V2-S and the MobileNet-V3 forwards; the
        bf16 builds over the bf16 forwards of B0 (MBConv) and V2-S
        (Fused-MBConv).  ``launches[net]`` are the counts of that network's
        main path."""
        out = []
        for kernel in REPLACES:
            errs = [r["max_abs_err"] for r in self.rows
                    if r["kernel"] == kernel]
            entry = {"name": kernel, "route": "cuda",
                     "source": SOURCES[kernel], "replaces": REPLACES[kernel],
                     "max_abs_err": max(errs)}
            if kernel == "conv1d":
                n, layer = self.sums(kernel, "mamba2", LM_TOKENS)
                n_layers = launches["lm"][kernel] // len(LM_CONVS)
                entry.update(
                    launches=launches["lm"][kernel],
                    **{k: v * n_layers if isinstance(v, float) else v
                       for k, v in layer.items()},
                    per_layer=dict(layer, launches=n),
                    per_conv=self.conv1d_per_conv("mamba2", LM_TOKENS),
                    shape=f"Mamba-2 2.7B bf16 prefill, batch 1 x {LM_TOKENS} "
                          f"tokens: {n_layers} layers x the {n} convs of a "
                          f"layer (D {', '.join(str(d) for _, d in LM_CONVS)}, "
                          f"k 4, SiLU), each timed once; library: grouped "
                          f"F.conv1d + F.silu")
                train = launches["lm_train"][kernel]
                n_tr, tr = self.sums(kernel, "mamba2_train", LM_TRAIN_BATCH[1])
                per_step = train // LM_TRAIN_STEPS // n_tr
                entry["lm_train"] = dict(
                    {k: v * per_step if isinstance(v, float) else v
                     for k, v in tr.items()},
                    launches=train, steps=LM_TRAIN_STEPS,
                    per_layer=dict(tr, launches=n_tr),
                    per_conv=self.conv1d_per_conv("mamba2_train",
                                                  LM_TRAIN_BATCH[1]),
                    max_abs_err=max(r["max_abs_err"] for r in self.rows
                                    if r["kernel"] == kernel
                                    and r["net"] == "mamba2_train"),
                    shape=f"Mamba-2 2.7B bf16 training step, batch "
                          f"{LM_TRAIN_BATCH[0]} x {LM_TRAIN_BATCH[1]} tokens, "
                          f"remat: {n_layers} layers x the {n_tr} convs, in "
                          f"the forward and the recompute; times are one "
                          f"step's ({per_step} x each conv timed once)")
                n_rg, rg = self.sums(kernel, "rgemma", RG_TOKENS)
                rg_launches = launches["rgemma"][kernel]
                entry["rgemma"] = dict(
                    {k: v * rg_launches if isinstance(v, float) else v
                     for k, v in rg.items()},
                    launches=rg_launches, per_layer=dict(rg, launches=n_rg),
                    per_conv=self.conv1d_per_conv("rgemma", RG_TOKENS),
                    max_abs_err=max(r["max_abs_err"] for r in self.rows
                                    if r["kernel"] == kernel
                                    and r["net"] == "rgemma"),
                    shape=f"RecurrentGemma-9B bf16 prefill, batch 1 x "
                          f"{RG_TOKENS} tokens: {rg_launches} RG-LRU layers "
                          f"x its temporal conv (D 4096, k 4, bias, no "
                          f"activation), timed once; library: grouped "
                          f"F.conv1d")
            elif kernel == "fused_separable_reduce":
                n, sums = self.sums(kernel, "mnv2", MNV2_RES)
                entry.update(launches=0, folded_into="fused_separable",
                             **sums,
                             shape=f"MobileNet-V2 {MNV2_RES}x{MNV2_RES} "
                                   f"batch {BATCH}: the {n} blocks whose "
                                   f"C_in is split; folded into the split "
                                   f"launch of fused_separable (its time "
                                   f"is in that kernel's ms), checked "
                                   f"exact against the plain split-order "
                                   f"sum of the launch's own partials on "
                                   f"every split block; plain time on "
                                   f"those partials")
            elif kernel.startswith("mbconv_splitk_reduce"):
                n, sums = self.sums(kernel, "b0", RES)
                entry.update(
                    launches=0,
                    folded_into="mbconv_pass2_retain, mbconv_pass2_recompute",
                    **sums,
                    shape=f"EfficientNet-B0 {RES}x{RES} batch {BATCH}"
                          f"{' in bf16' if kernel.endswith('_bf16') else ''}"
                          f", {n} split blocks of the main path: folded "
                          f"into the split launches of retain and "
                          f"recompute (its time is in theirs), checked "
                          f"exact against the plain split-order sum of "
                          f"the launch's own partials on every split "
                          f"block of B0, V2-S and V3; plain and library "
                          f"times on those partials")
                for net, res in (("v2s", V2S_RES), ("v3", V3_RES)):
                    n_net, net_sums = self.sums(kernel, net, res)
                    entry[net] = dict(net_sums or {}, launches=0,
                                      blocks=n_net)
            elif kernel in ("fused_separable", "dw2d"):
                n, sums = self.sums(kernel, "mnv2", MNV2_RES)
                n_tr, tr_sums = self.sums(kernel, "trainer", 32)
                note = (" (times with the folded split sum)"
                        if kernel == "fused_separable" else "")
                entry.update(launches=launches["train"][kernel], **sums,
                             shape=f"MobileNet-V2 {MNV2_RES}x{MNV2_RES} "
                                   f"batch {BATCH}, {n} separable blocks"
                                   f"{note}; launches of the trainer's "
                                   f"{TRAIN_STEPS} fused + {STAGED_STEPS} "
                                   f"staged steps",
                             trainer=dict(tr_sums, blocks=n_tr),
                             mnv2_path_launches=launches["mnv2"][kernel])
                if kernel == "dw2d":
                    entry["paper_staged_launches"] = \
                        launches["paper_staged_dw2d"]
            elif kernel == "dw2d_bf16":
                n, sums = self.sums(kernel, "mnv2_bf16", MNV2_RES)
                entry.update(
                    launches=launches["mnv2_staged_bf16"][kernel], **sums,
                    dtype="bfloat16",
                    fp32_ms=self.sums("dw2d", "mnv2", MNV2_RES)[1]["ms"],
                    shape=f"MobileNet-V2 {MNV2_RES}x{MNV2_RES} batch "
                          f"{BATCH} in bf16 (fp32 sums), {n} blocks' strips "
                          f"at the fp32 rows' tile_h, each at the launch "
                          f"shape dw2d_bf16_plan solves; launches of those "
                          f"blocks through separable_block(fused=False) in "
                          f"bf16; bound_ms at 2 bytes a stored element; "
                          f"library: bf16 F.conv2d(groups=C)")
            elif kernel == "fused_separable_bf16":
                n, sums = self.sums(kernel, "mnv2_bf16", MNV2_RES)
                entry.update(
                    launches=launches["mnv2_bf16"][kernel], **sums,
                    dtype="bfloat16",
                    past_one_ulp=sum(r["past_one_ulp"] for r in self.rows
                                     if r["kernel"] == kernel),
                    fp32_ms=self.sums("fused_separable", "mnv2",
                                      MNV2_RES)[1]["ms"],
                    bound_split_ms=sum(
                        r["bound_split_ms"] for r in self.rows
                        if r["kernel"] == kernel and r["on_path"]),
                    shape=f"MobileNet-V2 {MNV2_RES}x{MNV2_RES} batch "
                          f"{BATCH} in bf16 (fp32 sums; the pointwise on "
                          f"bf16 tensor cores through the exact three-term "
                          f"split, the C_in splits a thread-block cluster "
                          f"summed in distributed shared memory), {n} "
                          f"separable blocks at the bf16 schedules; "
                          f"launches of those blocks through separable_block "
                          f"in bf16; bound_ms at 2 bytes a stored element, "
                          f"the pointwise products at the bf16 tensor-core "
                          f"rate and the depthwise at fp32's; "
                          f"bound_split_ms adds the split's mid and lo "
                          f"products and the fold's adds")
            elif kernel.endswith("_bf16"):
                net, res, title = (
                    ("v2s", V2S_RES, "EfficientNet-V2-S")
                    if kernel == "fusedmb_bf16" else
                    ("b0", RES, "EfficientNet-B0"))
                n, sums = self.sums(kernel, net, res)
                entry.update(
                    launches=launches[f"{net}_bf16"][kernel], **sums,
                    dtype="bfloat16",
                    past_one_ulp=sum(r["past_one_ulp"] for r in self.rows
                                     if r["kernel"] == kernel),
                    shape=f"{title} {res}x{res} batch {BATCH} in bf16 (fp32 "
                          f"sums), "
                          f"{n} blocks of the bf16 forward's schedules; "
                          f"launches of that forward; bound_ms at 2 bytes "
                          f"a stored element, expand, conv and projection "
                          f"products at the bf16 tensor-core rate, the "
                          f"rest at fp32's")
                if kernel == "fusedmb_bf16":
                    # the fp32 build on the same blocks in this run
                    entry["fp32_ms"] = self.sums("fusedmb", net, res)[1]["ms"]
                else:
                    entry["shape"] += "; also over the V2-S and V3 blocks"
                    for net, res in (("v2s", V2S_RES), ("v3", V3_RES)):
                        n_net, net_sums = self.sums(kernel, net, res)
                        entry[net] = dict(
                            net_sums or {}, blocks=n_net,
                            launches=launches[f"{net}_bf16"][kernel])
                if kernel == "mbconv_pass2_retain_bf16":
                    for net, res in (("b0", RES), ("v2s", V2S_RES),
                                     ("v3", V3_RES)):
                        se = [r for r in self.rows if r["kernel"] == kernel
                              and r["net"] == net and r["res"] == res
                              and r["on_path"] and "ms_without_gate" in r]
                        entry.setdefault("se_blocks", {})[net] = {
                            "blocks": len(se),
                            "ms": sum(r["ms"] for r in se),
                            "ms_without_gate": sum(r["ms_without_gate"]
                                                   for r in se)}
            elif kernel == "fusedmb":
                n, sums = self.sums(kernel, "v2s", V2S_RES)
                entry.update(launches=launches["v2s"][kernel], **sums,
                             shape=f"EfficientNet-V2-S {V2S_RES}x{V2S_RES} "
                                   f"batch {BATCH}, {n} fused blocks")
            elif kernel == "mbconv_pool_reduce":
                n, sums = self.sums(kernel, "b0", RES)
                entry.update(launches=0, folded_into="mbconv_pass1", **sums,
                             shape=f"EfficientNet-B0 {RES}x{RES} batch "
                                   f"{BATCH}, {n} SE blocks: folded into "
                                   f"pass 1's epilogue (its time is in "
                                   f"mbconv_pass1's ms), checked exact "
                                   f"against the plain tile-order sum on "
                                   f"every SE block of B0, V2-S and V3; "
                                   f"plain and library times on pass 1's "
                                   f"partials")
            else:
                n, sums = self.sums(kernel, "b0", RES)
                entry.update(launches=launches["b0"][kernel], **sums,
                             shape=f"EfficientNet-B0 {RES}x{RES} batch "
                                   f"{BATCH}, {n} blocks of the main path; "
                                   f"checked at "
                                   f"{', '.join(map(str, SERVE_RES))}, on "
                                   f"V2-S and on MobileNet-V3")
                for net, res in (("v2s", V2S_RES), ("v3", V3_RES)):
                    n_net, net_sums = self.sums(kernel, net, res)
                    entry[net] = dict(net_sums or {},
                                      launches=launches[net][kernel],
                                      blocks=n_net)
            out.append(entry)
        return out


LIBRARIES = ("mbconv", "mbconv_bf16", "fusedmb", "fusedmb_bf16", "separable",
             "conv1d")
PTXAS_SOURCES = ("mbconv", "mbconv_bf16", "fusedmb", "fusedmb_bf16",
                 "separable", "conv1d")
PTXAS_KERNELS = ("mbconv_pass1_kernel", "mbconv_pass2_recompute_kernel",
                 "mbconv_pass2_retain_kernel", "fusedmb_kernel",
                 "fused_separable_kernel", "fused_separable_mma",
                 "dw2d_kernel", "dw2d_bf16_kernel", "causal_conv1d_kernel")


def ptxas_report():
    """Per instantiation of PTXAS_KERNELS in each library of PTXAS_SOURCES:
    registers, static shared memory, stack and spill bytes, as ptxas
    printed them in the library's build (``-Xptxas -v``)."""
    import re
    from repro_torch.kernels import _build
    report = {}
    for source in PTXAS_SOURCES:
        out = _build.build_log(source)
        names, rows, fn = {}, {}, None
        for line in out.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                fn = m.group(1)
                continue
            if fn is None or not any(k in fn for k in PTXAS_KERNELS):
                continue
            row = rows.setdefault(fn, {})
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                v = re.search(pat, line)
                if v:
                    row[key] = int(v.group(1))
        if rows and shutil.which("c++filt"):
            dem = subprocess.run(["c++filt"], input="\n".join(rows),
                                 capture_output=True,
                                 text=True).stdout.split("\n")
            names = dict(zip(rows, dem))
        kernel = "|".join(PTXAS_KERNELS)
        short = lambda n: (re.search(rf"(?:{kernel})<[^>]*>", n)  # noqa: E731
                           or re.search(r".*", n)).group(0)
        print(f"  nvcc -Xptxas -v, library {source}:")
        for fn, row in sorted((short(names.get(f, f)), r)
                              for f, r in rows.items()):
            print(f"    {fn[:110]}: {row}")
            report[f"{source}: {fn}"] = row
    return report


def sass_mma_counts():
    """HMMA (tensor-core product) instructions per kernel of each MBConv
    and Fused-MBConv library and the separable library, counted in its
    SASS (``cuobjdump -sass``): the bf16 builds' expand (pass 1,
    recompute), retain GEMM and Fused-MBConv kernel and the separable
    library's bf16 fused_separable_mma run on tensor cores, the fp32
    builds and the fp32 fused_separable_kernel on none.  Returns (counts,
    ok)."""
    import re
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    kernel = re.compile("|".join(PTXAS_KERNELS))
    counts = {}
    for name in ("mbconv", "mbconv_bf16", "fusedmb", "fusedmb_bf16",
                 "separable"):
        sass = subprocess.run([tool, "-sass", str(_build.build([name])[name])],
                              capture_output=True, text=True,
                              timeout=600).stdout
        per, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                k = kernel.search(m.group(1))
                fn = k.group(0) if k else "other"
            elif "HMMA" in line and fn is not None:
                per[fn] = per.get(fn, 0) + 1
        counts[name] = per
    total = {name: sum(per.values()) for name, per in counts.items()}
    ok = (total["mbconv"] == 0 and total["fusedmb"] == 0
          and all(counts["mbconv_bf16"].get(k, 0) > 0
                  for k in PTXAS_KERNELS[:3])
          and counts["fusedmb_bf16"].get("fusedmb_kernel", 0) > 0
          and counts["separable"].get("fused_separable_mma", 0) > 0
          and counts["separable"].get("fused_separable_kernel", 0) == 0)
    print(f"  HMMA instructions in the SASS, per kernel: {counts} "
          f"({'ok' if ok else 'FAIL'}: the bf16 builds' pass 1, recompute, "
          f"retain and Fused-MBConv kernel and fused_separable_mma on "
          f"tensor cores, the fp32 builds and fused_separable_kernel on "
          f"none)")
    return counts, ok


def _sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _phase(name):
    print(f"\n=== {name} ===", flush=True)
    return time.perf_counter()


class _Harness:
    """Inputs from one seeded generator, the error bar, and the timing
    of a kernel beside its plain and library versions."""

    def __init__(self, torch, seed):
        self.torch = torch
        self.gen = torch.Generator().manual_seed(seed)
        self.dev = torch.device(DEVICE)

    def rand(self, *shape, scale=1.0):
        return (self.torch.randn(*shape, generator=self.gen)
                * scale).to(self.dev)

    @staticmethod
    def check(got, ref):
        err = float((got - ref).abs().max())
        return err, KERNEL_RTOL * float(ref.abs().max()) + KERNEL_ATOL

    @staticmethod
    def times(timed, kernel, plain, library=None):
        """Device ms of 20 calls replayed from one CUDA graph (kernel,
        plain version, one-call library version) and the kernel's
        host-inclusive ms of 20 eager calls; None when not ``timed``, and
        the kernel's times None where it is None (folded into another)."""
        from repro_torch.core.telemetry import measure
        if not timed:
            return None
        dev_ms = lambda fn: None if fn is None else measure(  # noqa: E731
            fn, iters=20, graph=True).mean_ms
        return {"ms": dev_ms(kernel), "plain_ms": dev_ms(plain),
                "library_ms": dev_ms(library),
                "host_ms": None if kernel is None
                else measure(kernel, iters=20).mean_ms}


def _mbconv_checks(torch, tk, stats, hx, net, res, i, row, sp, sch, timed,
                   sch_bf16=None):
    """Every MBConv kernel variant a block of spec ``sp`` can run, on one
    block, against its plain version: the spec's activation, and with SE
    (pool partials, the folded pool, a gate of the spec's flavour) or
    without (no partials, no pool, ``gate=None``).  ``timed(on_path)``
    says which are timed.  Given ``sch_bf16`` (the block's bf16 schedule),
    the bf16 builds too, on the same inputs (``_mbconv_bf16_checks``)."""
    from repro_torch.core.autotune import get_mbconv_schedule, recompute_plan

    h, w, c_in, c_mid, c_out, k, s = row[:7]
    identity = c_mid == c_in
    se = sp.has_se
    geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", sch.tile_h, sch.tile_w)
    oh, ow, b = geo.out_h, geo.out_w, BATCH
    x = hx.rand(b, h, w, c_in)
    w_exp = None if identity else hx.rand(c_in, c_mid, scale=c_in ** -0.5)
    w_dw = hx.rand(k, k, c_mid, scale=k ** -1.0)
    gate_fn = {"sigmoid": torch.sigmoid,
               "hard_sigmoid": torch.nn.functional.hardsigmoid}[sp.gate_act]
    gate = gate_fn(hx.rand(b, c_mid)) if se else None
    w_proj = hx.rand(c_mid, c_out, scale=c_mid ** -0.5)
    acts = dict(exp_act=None if identity else sp.act, dw_act=sp.act)
    shape = dict(h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out, k=k,
                 s=s, tile=f"{geo.tile_h}x{geo.tile_w}", mode=sch.mode,
                 act=sp.act, se=se)
    x_b = 4 * b * h * w * c_in
    dw_b = 4 * b * oh * ow * c_mid
    part_b = 4 * b * geo.n_tiles * c_mid if se else 0
    w1_b = 4 * ((0 if identity else c_in * c_mid) + k * k * c_mid)
    w2_b = 4 * ((b * c_mid if se else 0) + c_mid * c_out)
    out_b = 4 * b * oh * ow * c_out
    exp_f = 0 if identity else 2 * b * h * w * c_in * c_mid
    dw_f = 2 * b * oh * ow * c_mid * k * k
    gate_f = b * oh * ow * c_mid if se else 0    # pool adds, gate products
    proj_f = 2 * b * oh * ow * c_mid * c_out + gate_f
    print(f"{net} r{res} block{i:02d} {shape}", flush=True)

    ok = True
    # without SE, pass 1 runs only to write the DW tensor (retain)
    for retain in ((False, True) if se else (True,)):
        on_path = retain == (sch.mode == "retain")
        got = tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se, retain=retain,
                              **acts)
        ref = tk.mbconv_pass1_plain(x, w_exp, w_dw, geo, se=se,
                                    retain=retain, **acts)
        err, tol = max((hx.check(g, r) for g, r in zip(got, ref)
                        if r is not None), key=lambda et: et[0] - et[1])
        ok &= stats.add(
            "mbconv_pass1", net, res, i, on_path, err, tol,
            hx.times(timed(on_path),
                     lambda: tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se,
                                             retain=retain, **acts),
                     lambda: tk.mbconv_pass1_plain(x, w_exp, w_dw, geo,
                                                   se=se, retain=retain,
                                                   **acts)),
            x_b + w1_b + part_b + (dw_b if retain else 0),
            exp_f + dw_f + gate_f, retain=retain, **shape)
    if se:
        # the SE pool reduce, folded into pass 1: its pool is exactly the
        # tile-order sum of its own partials (no launch, no time of its
        # own; its plain and library versions timed on those partials)
        partial, pool = got[:2]
        err = float((pool - tk.mbconv_pool_reduce_plain(partial)).abs().max())
        ok &= stats.add(
            "mbconv_pool_reduce", net, res, i, True, err, 0.0,
            hx.times(timed(True), None,
                     lambda: tk.mbconv_pool_reduce_plain(partial),
                     lambda: partial.sum(dim=1)),
            part_b + 4 * b * c_mid, b * geo.n_tiles * c_mid,
            folded_into="mbconv_pass1", **shape)
    dw = ref[2].contiguous()

    on_path = sch.mode == "recompute"
    # a retain block's pass-1 tile may pass B2's cap: off the path, the
    # recompute kernel runs at the tile a recompute pin would solve
    pin = get_mbconv_schedule(b, h, w, c_in, c_mid, c_out, k, s,
                              se_ratio=sp.se_ratio, mode="recompute")
    g2 = geo if on_path else tk.MBConvGeometry.make(
        h, w, k, s, "SAME", pin.tile_h, pin.tile_w)
    co_tile, b2_splits = recompute_plan(b, oh, ow, c_mid, c_out, g2.tile_h,
                                        g2.tile_w)
    got, part = tk.mbconv_pass2_recompute_with_partials(
        x, w_exp, w_dw, gate, w_proj, g2, **acts)
    if not torch.equal(got, tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate,
                                                      w_proj, g2, **acts)):
        print(f"  {net} r{res} block{i:02d} recompute does not repeat bit "
              "for bit: FAIL")
        ok = False
    ref = tk.mbconv_pass2_recompute_plain(x, w_exp, w_dw, gate, w_proj,
                                          g2, **acts)
    nbytes, flops = x_b + w1_b + w2_b + out_b, exp_f + dw_f + proj_f
    ok &= stats.add(
        "mbconv_pass2_recompute", net, res, i, on_path, *hx.check(got, ref),
        hx.times(timed(on_path),
                 lambda: tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate,
                                                   w_proj, g2, **acts),
                 lambda: tk.mbconv_pass2_recompute_plain(
                     x, w_exp, w_dw, gate, w_proj, g2, **acts)),
        nbytes, flops,
        **dict(shape, tile=f"{g2.tile_h}x{g2.tile_w}",
               co_tiles=-(-c_out // co_tile), co_tile=co_tile,
               splits=b2_splits),
        **_split_bound(b2_splits, b * oh * ow * c_out, nbytes, flops))
    if part is not None:
        ok &= _fold_check(torch, tk, stats, hx, net, res, i, on_path, timed,
                          got, part, torch.float32, "mbconv_pass2_recompute",
                          **dict(shape, tile=f"{g2.tile_h}x{g2.tile_w}"))

    on_path = sch.mode == "retain"
    got, part = tk.mbconv_pass2_retain_with_partials(dw, gate, w_proj, geo,
                                                     sch.retain_splits)
    again = tk.mbconv_pass2_retain(dw, gate, w_proj, geo, sch.retain_splits)
    if not torch.equal(got, again):
        print(f"  {net} r{res} block{i:02d} retain does not repeat bit for "
              "bit: FAIL")
        ok = False
    ref = tk.mbconv_pass2_retain_plain(dw, gate, w_proj, geo)
    library = ((lambda: torch.einsum("bhwc,bc,co->bhwo", dw, gate, w_proj))
               if se else (lambda: dw @ w_proj))
    splits = tk.retain_plan(b * oh * ow, c_mid, c_out, sch.retain_splits)[2]
    ok &= stats.add(
        "mbconv_pass2_retain", net, res, i, on_path, *hx.check(got, ref),
        hx.times(timed(on_path),
                 lambda: tk.mbconv_pass2_retain(dw, gate, w_proj, geo,
                                                sch.retain_splits),
                 lambda: tk.mbconv_pass2_retain_plain(dw, gate, w_proj,
                                                      geo),
                 library),
        dw_b + w2_b + out_b, proj_f, splits=splits,
        **_split_bound(splits, b * oh * ow * c_out, dw_b + w2_b + out_b,
                       proj_f), **shape)
    if part is not None:
        ok &= _fold_check(torch, tk, stats, hx, net, res, i, on_path, timed,
                          got, part, torch.float32, "mbconv_pass2_retain",
                          **shape)
    if sch_bf16 is not None:
        ok &= _mbconv_bf16_checks(torch, tk, stats, hx, net, res, i, row, sp,
                                  sch_bf16, (x, w_exp, w_dw, gate, w_proj),
                                  timed)
    _sync(torch)
    return ok


def _split_bound(splits, count, nbytes, flops, mma_flops=0):
    """``bound_split_ms`` of a split launch's per-block row: its bound with
    the scratch of its own split decomposition added (the fp32 partials of
    ``count`` outputs written and read back once, (splits - 1) adds an
    output).  The function needs none of it, so it stays out of
    ``bound_ms`` and out of the kernels line; {} unsplit."""
    if splits == 1:
        return {}
    return dict(bound_split_ms=_bound(nbytes + 8 * splits * count,
                                      flops + (splits - 1) * count,
                                      mma_flops)[0])


def _fold_check(torch, tk, stats, hx, net, res, i, on_path, timed, got,
                part, out_dtype, into, **shape):
    """B3' (``mbconv_splitk_reduce``, folded into ``into``): the split
    launch's output ``got`` exactly the plain split-order sum of the
    partials ``part`` the same launch left behind, rounded once to
    ``out_dtype``.  No launch and no time of its own; its plain version (and
    in fp32 its library call, ``part.sum(dim=0)``) timed on those
    partials, its bound their read and the output's write."""
    fp32 = out_dtype == torch.float32
    name = "mbconv_splitk_reduce" + ("" if fp32 else "_bf16")
    want = tk.mbconv_splitk_reduce_plain(part, out_dtype)
    exact = torch.equal(got, want)
    err = float((got.float() - want.float()).abs().max())
    splits, count = part.shape[0], got.numel()
    print(f"  {net} r{res} block{i:02d} {name} folded into {into}: "
          f"{splits} splits, output {'exactly' if exact else 'NOT'} the "
          f"split-order sum of its partials")
    return stats.add(
        name, net, res, i, on_path, err, 0.0,
        hx.times(timed(on_path), None,
                 lambda: tk.mbconv_splitk_reduce_plain(part, out_dtype),
                 (lambda: part.sum(dim=0)) if fp32 else None),
        4 * splits * count + out_dtype.itemsize * count, (splits - 1) * count,
        good=exact, folded_into=into, splits=splits,
        **dict(shape, dtype=str(out_dtype).split(".")[-1]))


def _bf16_verdict(got, ref32):
    """A bf16 output against the plain version's fp32 result on the same
    bf16 inputs: (good, max|err|, the fp32 bar, worst bf16 ulps, elements
    past 1 ulp).  Good: within 1 bf16 ulp of the fp32 sum everywhere,
    except where the two fp32 summation orders alone differ by more than
    that ulp (outputs near 0 of long sums), which are held to the fp32 bar
    (KERNEL_RTOL x max|ref| + KERNEL_ATOL) instead."""
    import torch
    ulp = _bf16_ulp(ref32)
    err = (got.float() - ref32).abs()
    bar = KERNEL_RTOL * float(ref32.abs().max()) + KERNEL_ATOL
    good = bool((err <= torch.clamp(ulp, min=bar)).all())
    return (good and got.dtype == torch.bfloat16, float(err.max()), bar,
            float((err / ulp).max()), int((err > ulp).sum()))


def _mbconv_bf16_checks(torch, tk, stats, hx, net, res, i, row, sp, sch,
                        ops, timed):
    """The block's MBConv kernels in bf16 at its bf16 schedule ``sch``, on
    the fp32 checks' inputs ``ops`` (x, w_exp, w_dw, gate, w_proj) rounded
    to bf16, the gate kept fp32: pass 1's retained DW, recompute's and
    retain's outputs against their plain versions on the same bf16 values
    (``_bf16_verdict``), a split launch's output exactly its partials'
    split-order sum (``_fold_check``), pass 1's fp32 pool partials at the
    fp32 bar and its pool exactly their tile-order sum.
    Rows are named ``<kernel>_bf16``; bytes at 2 per stored element (4 for
    the pool, its partials, the gate and split partials); the expand's and
    the projection's products at the bf16 tensor-core rate, the depthwise,
    gate and sums at fp32's."""
    from repro_torch.core.autotune import get_mbconv_schedule, recompute_plan

    h, w, c_in, c_mid, c_out, k, s = row[:7]
    x, w_exp, w_dw, gate, w_proj = (None if t is None else
                                    t if t is ops[3] else t.bfloat16()
                                    for t in ops)
    f32 = lambda t: None if t is None else t.float()  # noqa: E731
    se, identity = sp.has_se, w_exp is None
    geo = tk.MBConvGeometry.make(h, w, k, s, "SAME", sch.tile_h, sch.tile_w)
    oh, ow, b = geo.out_h, geo.out_w, BATCH
    acts = dict(exp_act=None if identity else sp.act, dw_act=sp.act)
    shape = dict(h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out, k=k, s=s,
                 tile=f"{geo.tile_h}x{geo.tile_w}", mode=sch.mode,
                 act=sp.act, se=se, dtype="bfloat16")
    x_b, dw_b, out_b = (2 * b * h * w * c_in, 2 * b * oh * ow * c_mid,
                        2 * b * oh * ow * c_out)
    part_b = 4 * b * geo.n_tiles * c_mid if se else 0
    w1_b = 2 * ((0 if identity else c_in * c_mid) + k * k * c_mid)
    w2_b = (4 * b * c_mid if se else 0) + 2 * c_mid * c_out
    # bf16 products (expand, projection) apart from the fp32 work
    exp_f = 0 if identity else 2 * b * h * w * c_in * c_mid
    dw_f = 2 * b * oh * ow * c_mid * k * k
    gate_f = b * oh * ow * c_mid if se else 0
    proj_f = 2 * b * oh * ow * c_mid * c_out

    def add(kernel, on_path, verdict, times, nbytes, flops, mma_flops=0,
            **extra):
        good, err, bar, ulps, past = verdict
        print(f"  {net} r{res} block{i:02d} {kernel} bf16: worst {ulps:.3f} "
              f"bf16 ulp, {past} element(s) past 1 ulp within the fp32 bar "
              f"{bar:.3e}")
        return stats.add(f"{kernel}_bf16", net, res, i, on_path, err, bar,
                         times, nbytes, flops, good=good, bf16_ulps=ulps,
                         mma_flops=mma_flops,
                         past_one_ulp=past, **extra, **shape)

    ok = True
    for retain in ((False, True) if se else (True,)):
        on_path = retain == (sch.mode == "retain")
        got = tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se, retain=retain,
                              **acts)
        ref = tk.mbconv_pass1_plain(f32(x), f32(w_exp), f32(w_dw), geo,
                                    se=se, retain=retain, **acts)
        verdict = (_bf16_verdict(got[2], ref[2]) if retain
                   else (True, 0.0, 0.0, 0.0, 0))
        if se:
            err, tol = _Harness.check(got[0], ref[0])
            exact = torch.equal(got[1], tk.mbconv_pool_reduce_plain(got[0]))
            print(f"  {net} r{res} block{i:02d} mbconv_pass1 bf16 pool "
                  f"partials err {err:.3e} (tol {tol:.3e}), pool "
                  f"{'exactly' if exact else 'NOT'} their tile-order sum")
            verdict = (verdict[0] and err <= tol and exact,
                       max(verdict[1], err), *verdict[2:])
        if retain:
            dw = got[2]
        ok &= add("mbconv_pass1", on_path, verdict, hx.times(
            timed(on_path),
            lambda: tk.mbconv_pass1(x, w_exp, w_dw, geo, se=se,
                                    retain=retain, **acts),
            lambda: tk.mbconv_pass1_plain(x, w_exp, w_dw, geo, se=se,
                                          retain=retain, **acts)),
            x_b + w1_b + part_b + (dw_b if retain else 0),
            dw_f + gate_f, exp_f, retain=retain)

    on_path = sch.mode == "recompute"
    pin = get_mbconv_schedule(b, h, w, c_in, c_mid, c_out, k, s,
                              se_ratio=sp.se_ratio, dtype_bytes=2,
                              mode="recompute")
    g2 = geo if on_path else tk.MBConvGeometry.make(
        h, w, k, s, "SAME", pin.tile_h, pin.tile_w)
    co_tile, b2_splits = recompute_plan(b, oh, ow, c_mid, c_out, g2.tile_h,
                                        g2.tile_w)
    got, part = tk.mbconv_pass2_recompute_with_partials(
        x, w_exp, w_dw, gate, w_proj, g2, **acts)
    ok &= torch.equal(got, tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate,
                                                     w_proj, g2, **acts))
    ok &= add("mbconv_pass2_recompute", on_path, _bf16_verdict(
        got, tk.mbconv_pass2_recompute_plain(f32(x), f32(w_exp), f32(w_dw),
                                             gate, f32(w_proj), g2, **acts)),
        hx.times(timed(on_path),
                 lambda: tk.mbconv_pass2_recompute(x, w_exp, w_dw, gate,
                                                   w_proj, g2, **acts),
                 lambda: tk.mbconv_pass2_recompute_plain(
                     x, w_exp, w_dw, gate, w_proj, g2, **acts)),
        x_b + w1_b + w2_b + out_b, dw_f + gate_f, exp_f + proj_f,
        co_tile=co_tile, splits=b2_splits,
        **_split_bound(b2_splits, b * oh * ow * c_out,
                       x_b + w1_b + w2_b + out_b, dw_f + gate_f,
                       exp_f + proj_f))
    if part is not None:
        ok &= _fold_check(torch, tk, stats, hx, net, res, i, on_path, timed,
                          got, part, torch.bfloat16, "mbconv_pass2_recompute",
                          **dict(shape, tile=f"{g2.tile_h}x{g2.tile_w}"))

    on_path = sch.mode == "retain"
    cap = sch.retain_splits
    got, part = tk.mbconv_pass2_retain_with_partials(dw, gate, w_proj, geo,
                                                     cap)
    ok &= torch.equal(got, tk.mbconv_pass2_retain(dw, gate, w_proj, geo,
                                                  cap))
    gate_b = None if gate is None else gate.bfloat16()
    library = ((lambda: torch.einsum("bhwc,bc,co->bhwo", dw, gate_b, w_proj))
               if se else (lambda: dw @ w_proj))
    times = hx.times(timed(on_path),
                     lambda: tk.mbconv_pass2_retain(dw, gate, w_proj, geo, cap),
                     lambda: tk.mbconv_pass2_retain_plain(dw, gate, w_proj,
                                                          geo),
                     library)
    if times is not None and se:
        # the same GEMM without the gate: one product per tile in place of
        # the three of the exact split, what the split costs
        from repro_torch.core.telemetry import measure
        times["ms_without_gate"] = measure(
            lambda: tk.mbconv_pass2_retain(dw, None, w_proj, geo, cap),
            iters=20, graph=True).mean_ms
    splits = tk.retain_plan(b * oh * ow, c_mid, c_out, cap, 2)[2]
    ok &= add("mbconv_pass2_retain", on_path, _bf16_verdict(
        got, tk.mbconv_pass2_retain_plain(dw.float(), gate, f32(w_proj),
                                          geo)),
        times, dw_b + w2_b + out_b, gate_f, proj_f, splits=splits,
        **_split_bound(splits, b * oh * ow * c_out, dw_b + w2_b + out_b,
                       gate_f, proj_f))
    if part is not None:
        ok &= _fold_check(torch, tk, stats, hx, net, res, i, on_path, timed,
                          got, part, torch.bfloat16, "mbconv_pass2_retain",
                          **shape)
    return ok


def _fusedmb_checks(torch, tf, stats, hx, net, res, i, row, sch,
                    sch_bf16=None):
    """The Fused-MBConv kernel on one block against its plain version,
    timed.  No single PyTorch call computes conv + act + projection, so
    there is no library time.  Given ``sch_bf16`` (the block's bf16
    schedule), its bf16 build too, on the same inputs rounded to bf16,
    against the plain version's fp32 result on those values
    (``_bf16_verdict``), bit for bit on a second call, timed."""
    from repro_torch.core.autotune import fusedmb_mid_chunk
    h, w, c_in, c_mid, c_out, k, s = row[:7]
    geo = tf.MBConvGeometry.make(h, w, k, s, "SAME", sch.tile_h, sch.tile_w)
    oh, ow, b = geo.out_h, geo.out_w, BATCH
    x = hx.rand(b, h, w, c_in)
    w_conv = hx.rand(k, k, c_in, c_mid, scale=(k * k * c_in) ** -0.5)
    w_proj = hx.rand(c_mid, c_out, scale=c_mid ** -0.5)
    shape = dict(h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out, k=k, s=s,
                 tile=f"{geo.tile_h}x{geo.tile_w}", chunk=sch.chunk,
                 ci_chunk=sch.ci_chunk)
    print(f"{net} r{res} block{i:02d} {shape}", flush=True)
    got = tf.fusedmb(x, w_conv, w_proj, geo, act="silu")
    ref = tf.fusedmb_plain(x, w_conv, w_proj, geo, act="silu")
    repeats = torch.equal(got, tf.fusedmb(x, w_conv, w_proj, geo,
                                          act="silu"))
    if not repeats:
        print(f"  {net} r{res} block{i:02d} fusedmb does not repeat bit for "
              "bit: FAIL")
    nbytes = 4 * (b * h * w * c_in + k * k * c_in * c_mid + c_mid * c_out
                  + b * oh * ow * c_out)
    flops = 2 * b * oh * ow * (k * k * c_in * c_mid + c_mid * c_out)
    ok = stats.add(
        "fusedmb", net, res, i, True, *hx.check(got, ref),
        hx.times(True, lambda: tf.fusedmb(x, w_conv, w_proj, geo, act="silu"),
                 lambda: tf.fusedmb_plain(x, w_conv, w_proj, geo,
                                          act="silu")),
        nbytes, flops, **shape)
    if sch_bf16 is not None:
        xb, wcb, wpb = x.bfloat16(), w_conv.bfloat16(), w_proj.bfloat16()
        gb = tf.MBConvGeometry.make(h, w, k, s, "SAME", sch_bf16.tile_h,
                                    sch_bf16.tile_w)
        got = tf.fusedmb(xb, wcb, wpb, gb, act="silu")
        repeats &= torch.equal(got, tf.fusedmb(xb, wcb, wpb, gb, act="silu"))
        good, err, bar, ulps, past = _bf16_verdict(got, tf.fusedmb_plain(
            xb.float(), wcb.float(), wpb.float(), gb, act="silu"))
        print(f"  {net} r{res} block{i:02d} fusedmb bf16: worst {ulps:.3f} "
              f"bf16 ulp, {past} element(s) past 1 ulp within the fp32 bar "
              f"{bar:.3e}")
        # the exact split issues three products per projection term
        split = flops + 4 * b * oh * ow * c_mid * c_out
        ok &= stats.add(
            "fusedmb_bf16", net, res, i, True, err, bar,
            hx.times(True, lambda: tf.fusedmb(xb, wcb, wpb, gb, act="silu"),
                     lambda: tf.fusedmb_plain(xb, wcb, wpb, gb, act="silu")),
            nbytes // 2, 0, good=good, mma_flops=flops, bf16_ulps=ulps,
            past_one_ulp=past, bound_split_ms=_bound(nbytes // 2, 0,
                                                     split)[0],
            **dict(shape, tile=f"{gb.tile_h}x{gb.tile_w}",
                   chunk=sch_bf16.chunk, ci_chunk=sch_bf16.ci_chunk,
                   mid_chunk=fusedmb_mid_chunk(c_mid), dtype="bfloat16"))
    _sync(torch)
    return ok and repeats


def chain_kernel_phase(torch, tk, tf, stats, net, specs, res, seed,
                       timed, bf16=()) -> bool:
    """Every kernel of each block of a network's chain at ``res``, batch
    BATCH, against its plain version, with the tiles and modes the forward
    solves for that size; ``timed(on_path)`` says which are timed.  The
    families named in ``bf16`` are also checked in bf16, at the bf16
    forward's schedules, on the same inputs."""
    from repro_torch.models.mbconv import block_chain_rows, block_schedules

    half = -(-res // 2)
    rows = block_chain_rows(specs, half, half)
    schedules = block_schedules(specs, BATCH, res, res)
    bf16_schedules = block_schedules(specs, BATCH, res, res, dtype_bytes=2)
    hx = _Harness(torch, seed)
    ok = True
    for i, (row, sp, sch, sb) in enumerate(zip(rows, specs, schedules,
                                               bf16_schedules)):
        sb = sb if sp.family in bf16 else None
        if sp.family == "fusedmb":
            ok &= _fusedmb_checks(torch, tf, stats, hx, net, res, i, row,
                                  sch, sb)
        else:
            ok &= _mbconv_checks(torch, tk, stats, hx, net, res, i, row, sp,
                                 sch, timed, sb)
    return bool(ok)


def kernel_phase(torch, tk, tf, stats) -> bool:
    """Every MBConv kernel on every B0 block of every serve bucket against
    its plain version; at RES also timed (device and host-inclusive) and
    bounded."""
    from repro_torch.models.mbconv import EffNetConfig, effnet_block_specs

    specs = effnet_block_specs(EffNetConfig())
    ok = True
    for res in SERVE_RES:
        ok &= chain_kernel_phase(torch, tk, tf, stats, "b0", specs, res, res,
                                 lambda on_path, r=res: r == RES,
                                 ("mbconv",) if res == RES else ())
    return bool(ok)


def _cpu_tree(torch, tree):
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, list):
        return [_cpu_tree(torch, v) for v in tree]
    return {k: _cpu_tree(torch, v) for k, v in tree.items()}


def model_phase(torch, tk):
    from repro_torch.core.telemetry import measure
    from repro_torch.models.mbconv import (
        EffNetConfig, efficientnet_b0_apply, efficientnet_b0_def,
        effnet_block_specs)
    from repro_torch.models.param import materialize

    cfg = EffNetConfig()
    params = materialize(efficientnet_b0_def(cfg),
                         torch.Generator().manual_seed(0), DEVICE)
    images = torch.rand(BATCH, RES, RES, 3,
                        generator=torch.Generator().manual_seed(1))
    params_cpu = _cpu_tree(torch, params)
    ok = True
    with torch.inference_mode():
        ref = efficientnet_b0_apply(params_cpu, images, cfg)
        scale = float(ref.abs().max())
        modes = [None]
        while modes:
            mode = modes.pop(0)
            tk.reset_launches()
            logits = efficientnet_b0_apply(params, images.to(DEVICE), cfg,
                                           mode=mode)
            _sync(torch)
            launches = dict(tk.LAUNCHES)
            rel = float((logits.cpu() - ref).abs().max()) / scale
            good = (logits.shape == (BATCH, 1000)
                    and bool(torch.isfinite(logits).all())
                    and rel <= MODEL_RTOL)
            print(f"  mode={mode or 'solved'} logits {tuple(logits.shape)} "
                  f"max|cpu| {scale:.4e} rel err {rel:.3e} "
                  f"(tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}; "
                  f"launches {launches}")
            ok &= good
            if mode is None:
                for kern, pin in (("mbconv_pass2_recompute", "recompute"),
                                  ("mbconv_pass2_retain", "retain")):
                    if launches[kern] == 0:
                        modes.append(pin)
            # every B0 block has SE: one pass 1 (with its folded pool) each;
            # no folded sum launches on its own
            if (launches["mbconv_pass1"] != len(effnet_block_specs(cfg))
                    or any(k in launches for k in FOLDED)):
                ok = False
    images = images.to(DEVICE)

    def forward():
        return efficientnet_b0_apply(params, images, cfg)

    with torch.inference_mode():
        fwd = measure(forward, iters=10, warmup=2)
    print(f"  forward (B0 {RES}x{RES}, batch {BATCH}): {fwd.mean_ms:.3f} ms "
          "(CUDA events, mean of 10)")
    return bool(ok), params, params_cpu, forward, fwd.mean_ms


def trace_phase(torch, forward, fwd_ms, grad=False, calls=3):
    """Device time by kernel over ``calls`` calls of ``forward``
    (torch.profiler, under ``inference_mode`` unless ``grad``, when
    ``forward`` takes a backward too); the busy share is kernel time per
    call over the event-timed call.  Only the device's activity is
    recorded: the host's ops would add nothing read here and cost most of
    a training step's trace."""
    from torch.profiler import ProfilerActivity, profile

    mode = contextlib.nullcontext() if grad else torch.inference_mode()
    try:
        with mode, profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                forward()
            _sync(torch)
    except RuntimeError as exc:   # the trace is a diagnostic, not a check
        print(f"  the profiler failed ({exc}): not measured")
        return None
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            by_name[e.key] = by_name.get(e.key, 0.0) + us / calls / 1e3
    if not by_name:
        print("  the profiler shows no device time: not measured")
        return None
    groups = {}
    for name, ms in by_name.items():
        group = next((k + ("_bf16" if "bfloat16" in name else "")
                      for k in REPLACES if f"{k}_kernel" in name),
                     "other (cuDNN, cuBLAS, elementwise)")
        groups[group] = groups.get(group, 0.0) + ms
    device_ms = sum(by_name.values())
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:36s} {ms:.4f} ms per forward")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:16]:
        print(f"    {ms:.4f} ms  {name[:160]}")
    print(f"  device time per forward {device_ms:.4f} ms of {fwd_ms:.4f} ms: "
          f"busy {device_ms / fwd_ms:.1%}")
    return {"device_ms_per_forward": device_ms, "forward_ms": fwd_ms,
            "groups_ms": groups}


def serve_phase(torch, tk, params, params_cpu):
    import numpy as np
    from repro_torch.core import telemetry
    from repro_torch.models.mbconv import EffNetConfig, efficientnet_b0_apply
    from repro_torch.serve import VisionEngine, VisionServeConfig

    cfg = EffNetConfig()
    scfg = VisionServeConfig(resolutions=SERVE_RES, batch_size=BATCH,
                             max_queue=64)
    rng = np.random.default_rng(2)
    sides = (224, 200, 384, 300, 512, 480, 160, 350, 224, 500, 96, 640)
    images = [rng.random((sd, sd, 3), np.float32) for sd in sides]
    telemetry.reset()
    engine = VisionEngine(params, cfg, scfg, device=DEVICE)
    tk.reset_launches()                         # the main path starts here
    rids = [engine.submit(img, priority=int(n == 3))
            for n, img in enumerate(images)]
    results = engine.drain()
    _sync(torch)
    launches = dict(tk.LAUNCHES)                # ... and ends here
    t = telemetry.get_telemetry()
    snap = telemetry.snapshot()
    print("  counters:", json.dumps(snap["counters"], sort_keys=True)[:2000])
    pct = engine.latency_percentiles()
    print(f"  latency_s p50 {pct['p50']:.4f} p90 {pct['p90']:.4f} "
          f"p99 {pct['p99']:.4f}; launches {launches}")
    ok = True
    ok &= rids[-1] is None and t.get("serve.shed.oversize") == 1
    ok &= len(results) == len(sides) - 1
    ok &= all(np.isfinite(r.logits).all() and r.logits.shape == (1000,)
              for r in results)
    for res in scfg.resolutions:
        ok &= t.get(f"serve.build.r{res}") == 1
    ok &= all(launches[k] > 0 for k in tk.FP32_KERNELS)
    ok &= not any(k in launches for k in FOLDED)

    # requests of the 384 and 512 buckets (300 px and 480 px images, so
    # padded) against the plain versions on the CPU: a fault in the
    # kernels' tiling at those buckets shows here
    by_rid = {r.rid: r for r in results}
    for n in (3, 5):
        probe = by_rid[rids[n]]
        padded = np.zeros((1, probe.bucket, probe.bucket, 3), np.float32)
        padded[0, :sides[n], :sides[n]] = images[n]
        with torch.inference_mode():
            ref = efficientnet_b0_apply(
                params_cpu, torch.from_numpy(padded), cfg)[0].numpy()
        rel = float(np.abs(probe.logits - ref).max() / np.abs(ref).max())
        good = rel <= MODEL_RTOL
        print(f"  request {probe.rid} ({sides[n]} px, bucket {probe.bucket}) "
              f"vs the CPU plain run: rel err {rel:.3e} (tol {MODEL_RTOL:g}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    return bool(ok), launches, pct


def _net_on_card(torch, name, apply, params, cfg, images, n_cpu):
    """One forward of a network on the card with the launch counts zeroed
    just before and read just after (the network's main path), and its
    first ``n_cpu`` images against the CPU plain run."""
    from repro_torch.kernels import launches, reset_launches

    with torch.inference_mode():
        reset_launches()                        # the main path starts here
        logits = apply(params, images.to(DEVICE), cfg)
        _sync(torch)
        counts = launches()                     # ... and ends here
        ref = apply(_cpu_tree(torch, params), images[:n_cpu], cfg)
    scale = float(ref.abs().max())
    rel = float((logits[:n_cpu].cpu() - ref).abs().max()) / scale
    good = (logits.shape == (images.shape[0], cfg.num_classes)
            and bool(torch.isfinite(logits).all()) and rel <= MODEL_RTOL)
    print(f"  {name}: logits {tuple(logits.shape)}, first {n_cpu} vs the "
          f"CPU plain run: max|cpu| {scale:.4e} rel err {rel:.3e} "
          f"(tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}; "
          f"launches {counts}")
    return good, counts


def v2s_model_phase(torch):
    from repro_torch.core.telemetry import measure
    from repro_torch.models.mbconv import (
        EffNetV2Config, efficientnet_v2_s_apply, efficientnet_v2_s_def)
    from repro_torch.models.param import materialize

    cfg = EffNetV2Config()
    params = materialize(efficientnet_v2_s_def(cfg),
                         torch.Generator().manual_seed(0), DEVICE)
    images = torch.rand(BATCH, V2S_RES, V2S_RES, 3,
                        generator=torch.Generator().manual_seed(1))
    ok, counts = _net_on_card(torch, f"V2-S {V2S_RES}x{V2S_RES} batch "
                              f"{BATCH}", efficientnet_v2_s_apply, params,
                              cfg, images, V2S_CPU_IMAGES)
    n_mb = 30
    ok &= counts["fusedmb"] == 10
    ok &= counts["mbconv_pass1"] == n_mb         # each with SE: its pool
    ok &= not any(k in counts for k in FOLDED)
    ok &= (counts["mbconv_pass2_recompute"]
           + counts["mbconv_pass2_retain"]) == n_mb
    images = images.to(DEVICE)

    def forward():
        return efficientnet_v2_s_apply(params, images, cfg)

    with torch.inference_mode():
        fwd = measure(forward, iters=10, warmup=2)
    print(f"  forward (V2-S {V2S_RES}x{V2S_RES}, batch {BATCH}): "
          f"{fwd.mean_ms:.3f} ms (CUDA events, mean of 10)")
    return bool(ok), counts, forward, fwd.mean_ms


def v3_model_phase(torch):
    from repro_torch.core.telemetry import measure
    from repro_torch.models.mbconv import (
        MobileNetV3Config, block_schedules, mobilenet_v3_apply,
        mobilenet_v3_def, mobilenet_v3_specs)
    from repro_torch.models.param import materialize

    cfg = MobileNetV3Config()
    params = materialize(mobilenet_v3_def(cfg),
                         torch.Generator().manual_seed(0), DEVICE)
    images = torch.rand(BATCH, V3_RES, V3_RES, 3,
                        generator=torch.Generator().manual_seed(1))
    ok, counts = _net_on_card(torch, f"MobileNet-V3-Large {V3_RES}x{V3_RES} "
                              f"batch {BATCH}", mobilenet_v3_apply, params,
                              cfg, images, BATCH)
    ok &= (counts["mbconv_pass2_recompute"]
           + counts["mbconv_pass2_retain"]) == 15
    # one pass 1 on each block with SE (its pool folded in) or on retain
    specs = mobilenet_v3_specs(cfg)
    ok &= counts["mbconv_pass1"] == sum(
        sp.has_se or sch.mode == "retain" for sp, sch in zip(
            specs, block_schedules(specs, BATCH, V3_RES, V3_RES)))
    ok &= not any(k in counts for k in FOLDED)
    images = images.to(DEVICE)

    def forward():
        return mobilenet_v3_apply(params, images, cfg)

    with torch.inference_mode():
        fwd = measure(forward, iters=10, warmup=2)
    print(f"  forward (MobileNet-V3-Large {V3_RES}x{V3_RES}, batch {BATCH}): "
          f"{fwd.mean_ms:.3f} ms (CUDA events, mean of 10)")
    return bool(ok), counts, forward, fwd.mean_ms


def _bf16_nets():
    """(name, config class, def, apply, specs, side, stem act) of the
    three networks the bf16 phase runs."""
    from repro_torch.models import mbconv as tm
    return (("b0", tm.EffNetConfig, tm.efficientnet_b0_def,
             tm.efficientnet_b0_apply, tm.effnet_block_specs, RES, "silu"),
            ("v3", tm.MobileNetV3Config, tm.mobilenet_v3_def,
             tm.mobilenet_v3_apply, tm.mobilenet_v3_specs, V3_RES,
             "hard_swish"),
            ("v2s", tm.EffNetV2Config, tm.efficientnet_v2_s_def,
             tm.efficientnet_v2_s_apply, tm.effnet_v2_block_specs, V2S_RES,
             "silu"))


def _bf16_block_parity(torch, specs, params, images, stem_act):
    """Every block of a bf16 chain on the card, fed the card's bf16
    activation of the block before (so no difference compounds), against
    its plain oracle (``kernels.ref`` through ``kernel_bench._oracle``:
    fp32 sums of the same bf16 values, rounded once; the residual added in
    bf16): the worst max|err| over BF16_RTOL x max|ref| and its block."""
    from repro_torch.benchmarks.kernel_bench import _oracle
    from repro_torch.models.mbconv import apply_block, stem_conv
    act = {"silu": torch.nn.functional.silu,
           "hard_swish": torch.nn.functional.hardswish}[stem_act]
    x = act(stem_conv(images.bfloat16(), params["stem"].bfloat16()))
    worst = (0.0, -1)
    for i, sp in enumerate(specs):
        p = params[f"block{i}"]
        y = apply_block(x, sp, p)[0]
        pb = {k: v.bfloat16() if k in ("exp", "dw", "proj", "conv") else v
              for k, v in p.items()}
        ref = _oracle(x, sp, pb).float()
        ratio = (float((y.float() - ref).abs().max())
                 / (BF16_RTOL * float(ref.abs().max())))
        worst = max(worst, (ratio, i))
        x = y
    return worst


def bf16_model_phase(torch, fp32):
    """Each network's bf16 forward (its config's ``dtype="bfloat16"``) at
    full width, batch BATCH, the fp32 phases' seeded weights and images:
    launch counts zeroed just before and read just after (the bf16 main
    path: every MBConv / Fused-MBConv launch a bf16 build); B0's and V3's
    first BF16_CPU_IMAGES images' logits within BF16_RTOL x max|ref| of
    the CPU plain bf16 forward, V2-S block by block
    (``_bf16_block_parity``); each forward timed on CUDA events (mean of
    10) and traced, printed beside the fp32 forward's ``fp32[name]`` (ms,
    trace)."""
    from repro_torch.core.telemetry import measure
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.param import materialize

    ok, out = True, {}
    for name, cls, def_fn, apply, specs_fn, side, stem_act in _bf16_nets():
        cfg = cls(dtype="bfloat16")
        params = materialize(def_fn(cfg), torch.Generator().manual_seed(0),
                             DEVICE)
        images = torch.rand(BATCH, side, side, 3,
                            generator=torch.Generator().manual_seed(1))
        dev_images = images.to(DEVICE)
        with torch.inference_mode():
            reset_launches()                    # the main path starts here
            logits = apply(params, dev_images, cfg)
            _sync(torch)
            counts = launches()                 # ... and ends here
            fp32_launched = sum(n for k, n in counts.items()
                                if k.startswith(("mbconv_", "fusedmb"))
                                and not k.endswith("_bf16"))
            good = (logits.dtype == torch.bfloat16
                    and logits.shape == (BATCH, cfg.num_classes)
                    and bool(torch.isfinite(logits).all())
                    and fp32_launched == 0
                    and counts["mbconv_pass2_retain_bf16"] > 0
                    and not any(k in counts for k in FOLDED))
            if name == "v2s":
                ratio, block = _bf16_block_parity(
                    torch, specs_fn(cfg), params, dev_images, stem_act)
                good &= ratio <= 1.0 and counts["fusedmb_bf16"] == 10
                check = (f"block by block: worst max|err| {ratio:.3f} x "
                         f"{BF16_RTOL:g} x max|ref| (block {block})")
            else:
                ref = apply(_cpu_tree(torch, params),
                            images[:BF16_CPU_IMAGES], cfg).float()
                rel = (float((logits[:BF16_CPU_IMAGES].float().cpu()
                              - ref).abs().max())
                       / float(ref.abs().max()))
                good &= rel <= BF16_RTOL
                check = (f"first {BF16_CPU_IMAGES} vs the CPU plain bf16 "
                         f"run: rel err {rel:.3e} (tol {BF16_RTOL:g})")
        print(f"  {name} {side}x{side} batch {BATCH} bf16: logits "
              f"{tuple(logits.shape)} {logits.dtype}, {check} "
              f"{'ok' if good else 'FAIL'}; launches {counts}")
        ok &= good

        def forward():
            return apply(params, dev_images, cfg)

        with torch.inference_mode():
            fwd = measure(forward, iters=10, warmup=2)
        trace = trace_phase(torch, forward, fwd.mean_ms)
        fp32_ms, fp32_trace = fp32[name]
        def dev(t):
            if t is None:
                return "device time not measured"
            ms = t["device_ms_per_forward"]
            return f"{ms:.4f} ms device, busy {ms / t['forward_ms']:.1%}"

        print(f"  {name} forward: fp32 {fp32_ms:.3f} ms ({dev(fp32_trace)}); "
              f"bf16 {fwd.mean_ms:.3f} ms ({dev(trace)}) (CUDA events, mean "
              f"of 10; device time from the profiler)")
        out[name] = {"launches": counts, "forward_ms": fwd.mean_ms,
                     "trace": trace, "fp32_forward_ms": fp32_ms,
                     "fp32_trace": fp32_trace}
        del params, logits
    return bool(ok), out


def _convdk_on_card(torch):
    """(a) The executable ConvDK dataflow at full width on the card against
    its grouped-conv oracle: MobileNet-V2's two depthwise layers of largest
    map and a k=5, s=2 layer of B0."""
    from repro_torch.core.convdk import dwconv2d_convdk, dwconv2d_oracle
    from repro_torch.core.workloads import EFFICIENTNET_B0, MOBILENET_V2

    hx = _Harness(torch, 5000)
    ok = True
    for name, layer in (("MobileNet-V2 dw0", MOBILENET_V2[0]),
                        ("MobileNet-V2 dw1", MOBILENET_V2[1]),
                        ("EfficientNet-B0 dw3", EFFICIENTNET_B0[3])):
        x = hx.rand(layer.c, layer.h, layer.w)
        kern = hx.rand(layer.c, layer.k, layer.k, scale=1 / layer.k)
        got = dwconv2d_convdk(x, kern, stride=layer.s)
        ref = dwconv2d_oracle(x, kern, stride=layer.s)
        err, tol = hx.check(got, ref)
        good = got.shape == ref.shape and got.is_cuda and err <= tol
        print(f"  ConvDK {name} ({layer.c}x{layer.h}x{layer.w}, k{layer.k} "
              f"s{layer.s}) on {got.device}: err {err:.3e} (tol {tol:.3e}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
    return ok


PAPER_NETS = (("b0", "EfficientNet-B0", RES), ("v3l", "MobileNet-V3-Large",
                                               V3_RES),
              ("v2s", "EfficientNet-V2-S", V2S_RES))


def _dw2d_at_staged_blocks(torch, stats):
    """B6 against its plain version on the card at the shape of every
    staged MBConv block of PAPER_NETS: the expanded width, the block's
    kernel and stride, strips at the schedule's tile_h."""
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.kernels import convdk_dw as td
    from repro_torch.kernels import ops
    from repro_torch.kernels.convdk_mbconv import MBConvGeometry
    from repro_torch.kernels.ref import pad_nhwc

    hx = _Harness(torch, 7000)
    ok = True
    for net, _, res in PAPER_NETS:
        _, rows, schedules = kb.family_chain(net, BATCH, res)
        for i, (r, sch) in enumerate(zip(rows, schedules)):
            if r.family != "mbconv":
                continue
            geo = MBConvGeometry.make(r.h, r.w, r.k, r.s, "SAME", sch.tile_h,
                                      r.w)
            x = hx.rand(BATCH, r.h, r.w, r.c_mid)
            w = hx.rand(r.k, r.k, r.c_mid, scale=1 / r.k)
            strips = ops.stage_row_strips(pad_nhwc(x, geo.pads), r.k, r.s,
                                          geo.tile_h)
            kw = dict(stride=r.s, out_w=geo.out_w, tile_h=geo.tile_h)
            ok &= stats.add("dw2d", f"{net}-staged", res, i, True,
                            *hx.check(td.dw2d(strips, w, **kw),
                                      td.dw2d_plain(strips, w, **kw)),
                            h=r.h, w=r.w, c=r.c_mid, k=r.k, s=r.s,
                            tile_h=geo.tile_h)
    _sync(torch)
    return ok


def _forwards_both_ways(torch):
    """(c) Each network's forward fused and staged on the same weights and
    images: logits within MODEL_RTOL, the staged route's launches (one
    depthwise per MBConv block, no fused kernel), CUDA-event ms and the
    profiler's device time per route."""
    from repro_torch.core.telemetry import measure
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import mbconv as tm
    from repro_torch.models.param import materialize

    nets = {"b0": (tm.EffNetConfig(), tm.efficientnet_b0_def,
                   tm.efficientnet_b0_apply, tm.effnet_block_specs),
            "v3l": (tm.MobileNetV3Config(), tm.mobilenet_v3_def,
                    tm.mobilenet_v3_apply, tm.mobilenet_v3_specs),
            "v2s": (tm.EffNetV2Config(), tm.efficientnet_v2_s_def,
                    tm.efficientnet_v2_s_apply, tm.effnet_v2_block_specs)}
    ok, out, staged_dw = True, {}, 0
    for net, title, res in PAPER_NETS:
        cfg, define, apply, specs = nets[net]
        n_mb = sum(sp.family == "mbconv" for sp in specs(cfg))
        params = materialize(define(cfg), torch.Generator().manual_seed(0),
                             DEVICE)
        images = torch.rand(BATCH, res, res, 3,
                            generator=torch.Generator().manual_seed(1)
                            ).to(DEVICE)
        route = {}
        with torch.inference_mode():
            fused = apply(params, images, cfg)
            reset_launches()                    # the staged path starts here
            staged = apply(params, images, cfg, fused=False)
            _sync(torch)
            counts = launches()                 # ... and ends here
        staged_dw += counts["dw2d"]
        scale = float(fused.abs().max())
        rel = float((staged - fused).abs().max()) / scale
        good = (staged.shape == fused.shape == (BATCH, cfg.num_classes)
                and bool(torch.isfinite(staged).all())
                and bool(torch.isfinite(fused).all()) and rel <= MODEL_RTOL
                and counts["dw2d"] == n_mb
                and all(v == 0 for k, v in counts.items() if k != "dw2d"))
        print(f"  {title} {res}x{res} batch {BATCH}: staged vs fused logits "
              f"rel err {rel:.3e} (tol {MODEL_RTOL:g}); staged launches "
              f"{counts} (want dw2d {n_mb}) {'ok' if good else 'FAIL'}")
        ok &= good
        for fused_route in (True, False):
            name = "fused" if fused_route else "staged"

            def forward(f=fused_route):
                return apply(params, images, cfg, fused=f)

            with torch.inference_mode():
                ms = measure(forward, iters=10, warmup=2).mean_ms
            print(f"  {title} {name}: {ms:.3f} ms (CUDA events, mean of 10)")
            route[name] = {"forward_ms": ms,
                           "trace": trace_phase(torch, forward, ms)}
        out[net] = dict(route, rel_err=rel, staged_launches=counts)
        del params, images, fused, staged
    return ok, out, staged_dw


def paper_phase(torch, stats):
    """The paper's dataflow on the card: (a) ConvDK at full width against
    its oracle, (b) every block of B0 224, MobileNet-V3-Large 224 and V2-S
    384 (batch BATCH) fused and staged on the same inputs and weights, each
    within 1e-4 of max|oracle| of ``kernels.ref`` and of each other, timed
    warm (CUDA graph replays) and cold (a 128 MiB scratch write between
    calls), beside the modeled bytes and the staged working set, and B6
    against its plain version at every staged MBConv block's shape, (c)
    the three forwards both ways, (d) the CIM model's Figs. 7-8 beside the
    paper's bands (host arithmetic).  Speed never fails the phase."""
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.benchmarks.cim_tables import run_all
    from repro_torch.examples.cim_dataflow_analysis import band_rows

    ok = _convdk_on_card(torch)
    ok &= _dw2d_at_staged_blocks(torch, stats)
    blocks, peaks = [], {}
    for n, (net, title, res) in enumerate(PAPER_NETS):
        print(f"  -- {title} {res}x{res} batch {BATCH}, every block")
        torch.cuda.reset_peak_memory_stats()
        good, rows = kb.measure_family(net, BATCH, res, torch.device(DEVICE),
                                       seed=6000 + n)
        peaks[net] = torch.cuda.max_memory_allocated()
        ok &= good
        blocks += rows

        def total(key, rows=rows):
            return sum(r[key] for r in rows)

        print(f"  {title}: {len(rows)} blocks, fused {total('fused_ms'):.4f} "
              f"ms, staged {total('staged_ms'):.4f} ms warm; "
              f"{total('fused_cold_ms'):.4f} / {total('staged_cold_ms'):.4f} "
              f"ms cold; staged faster at "
              f"{sum(r['staged_ms'] < r['fused_ms'] for r in rows)} warm and "
              f"{sum(r['staged_cold_ms'] < r['fused_cold_ms'] for r in rows)}"
              f" cold; modeled fused below staged at "
              f"{sum(r['hopper_dram_bytes'] < r['staged_bytes'] for r in rows)}"
              f" (the copied model: "
              f"{sum(r['fused_bytes'] < r['staged_bytes'] for r in rows)}); "
              f"staged working set above L2 at "
              f"{sum(r['staged_working_set_bytes'] > kb.L2_BYTES for r in rows)}"
              f"; peak memory {peaks[net] / 2**30:.2f} GiB "
              f"{'ok' if good else 'FAIL'}")
    good, forwards, staged_dw = _forwards_both_ways(torch)
    ok &= good
    bands = band_rows(run_all(quiet=True))
    for band, lo, hi, p_lo, p_hi in bands:
        inside = p_lo <= lo and hi <= p_hi
        print(f"  CIM {band:38s} ours {lo:6.2f}..{hi:6.2f} paper "
              f"{p_lo:.1f}..{p_hi:.1f} {'inside' if inside else 'outside'}")
        if band == "buffer_traffic_reduction_ws":
            ok &= inside                 # the paper's headline claim
    return bool(ok), {"blocks": blocks, "peak_memory_bytes": peaks,
                      "forwards": forwards, "bands": bands}, staged_dw


BENCH_BASELINE_GLOB = os.path.join("results", "bench_torch", "BENCH_*.json")
BENCH_BLOCKS = 16 + 15 + 40                # B0, V3-Large, V2-S


def bench_phase(torch, tk, paper):
    """The port's measurement record: the per-block sweep written as a
    BENCH artifact, validated and diffed against the committed baseline,
    the calibration, the model's sign against the card's per block (from
    the paper phase's rows), and the serving report at SERVE_RES."""
    import glob

    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.benchmarks.roofline_bench import calibration_report
    from repro_torch.benchmarks.serve_report import serve_report
    from repro_torch.core.trajectory import diff_bench, load_bench, write_bench

    t0 = time.perf_counter()
    records = kb.measure_sweep(kb.FAMILY_CHOICES, torch.device(DEVICE),
                               seed=7000, log=lambda line: print("  " + line))
    path = write_bench(os.path.join(ROOT, "build", "chip_smoke"), records,
                       config=kb.BENCH_CONFIG)
    bench = load_bench(path)                 # validate_bench
    ok = len(bench["records"]) == BENCH_BLOCKS
    print(f"  sweep {time.perf_counter() - t0:.1f} s: {len(records)} records,"
          f" {sum(len(r['candidates']) for r in records)} points -> {path}")
    baselines = sorted(glob.glob(os.path.join(ROOT, BENCH_BASELINE_GLOB)))
    diff = None
    if len(baselines) != 1:
        print(f"  FAIL: want one committed baseline {BENCH_BASELINE_GLOB}, "
              f"found {baselines}")
        ok = False
    else:
        diff = diff_bench(load_bench(baselines[0]), bench)
        print("  vs " + os.path.relpath(baselines[0], ROOT) + "\n  "
              + diff.format().replace("\n", "\n  "))
        ok &= diff.ok
    calibration = calibration_report(path)

    agree = {"warm": 0, "cold": 0}
    sweep_us = {r["name"]: r["walltime_us"] for r in records}
    for row in paper["blocks"]:
        model = row["hopper_dram_bytes"] < row["staged_bytes"]
        warm = row["fused_ms"] < row["staged_ms"]
        cold = row["fused_cold_ms"] < row["staged_cold_ms"]
        name = f"{row['net']}_block{row['block']:02d}"
        agree["warm"] += model == warm
        agree["cold"] += model == cold
        print(f"  {row['net']} block{row['block']:02d} fused "
              f"{row['hopper_dram_bytes'] / 2**20:.2f} MiB device memory, "
              f"{row['hopper_global_bytes'] / 2**20:.2f} global; staged "
              f"{row['staged_bytes'] / 2**20:.2f} MiB; fused / staged "
              f"{row['fused_ms']:.4f} / {row['staged_ms']:.4f} ms warm, "
              f"{row['fused_cold_ms']:.4f} / {row['staged_cold_ms']:.4f} cold"
              f" (sweep {sweep_us[name] / 1e3:.4f})"
              f"; sign {'agrees' if model == warm else 'differs'} warm, "
              f"{'agrees' if model == cold else 'differs'} cold")
    n = len(paper["blocks"])
    print(f"  the model's sign agrees with the card's at {agree['warm']} of "
          f"{n} blocks warm, {agree['cold']} cold")

    tk.reset_launches()                      # the serving path starts here
    report = serve_report(SERVE_RES, device=DEVICE,
                          log=lambda line: print("  " + line))
    _sync(torch)
    launches = dict(tk.LAUNCHES)             # ... and ends here
    ran = all(launches[k] > 0 for k in ("mbconv_pass1", "mbconv_pass2_retain",
                                         "mbconv_pass2_recompute"))
    print(f"  serve_report launches {launches} "
          f"{'ok' if report['ok'] and ran else 'FAIL'}")
    ok &= report["ok"] and ran
    return bool(ok), {
        "artifact": os.path.relpath(path, ROOT),
        "diff_ok": diff is not None and diff.ok,
        "diff_notes": len(diff.notes) if diff else None,
        "calibration": calibration, "sign_agreement": agree,
        "serve_report": {k: report[k] for k in
                         ("ok", "requests", "rate_rps", "throughput_rps",
                          "warm_batch_s", "latency_s", "queue_wait_s",
                          "bucket_latency_s", "served", "shed")},
        "serve_report_launches": launches,
        "seconds": time.perf_counter() - t0}


def _separable_checks(torch, tfs, td, ops, stats, hx, net, res, i, b, h, w,
                      c, c_out, k, s, acts):
    """The fused separable kernel (its split sum B4' folded in where the
    block splits C_in: the output exactly act of the split-order sum of
    the partials the launch wrote) at each (dw_act, act) of ``acts`` (the
    first timed: the trainer's), and the depthwise kernel over the staged
    strips of the padded input, on one block, against their plain
    versions.  No PyTorch call computes the whole separable block, nor a
    sum of partials with an activation; one grouped F.conv2d on the
    unstaged input computes the depthwise one."""
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.kernels.convdk_mbconv import MBConvGeometry
    from repro_torch.kernels.ref import pad_nhwc

    sch = get_fused_schedule(b, h, w, c, c_out, k, s)
    geo = MBConvGeometry.make(h, w, k, s, "SAME", sch.tile_h, sch.tile_w)
    oh, ow = geo.out_h, geo.out_w
    x = hx.rand(b, h, w, c)
    w_dw = hx.rand(k, k, c, scale=1.0 / k)
    w_pw = hx.rand(c, c_out, scale=c ** -0.5)
    # the split route's partials (written once, read back once by the
    # launch's last CTAs) against the depthwise tensor the staged route
    # writes
    shape = dict(h=h, w=w, c_in=c, c_out=c_out, k=k, s=s, batch=b,
                 tile=f"{geo.tile_h}x{geo.tile_w}", co_tile=sch.co_tile,
                 splits=sch.splits,
                 partial_bytes=4 * sch.splits * b * oh * ow * c_out
                 if sch.splits > 1 else 0, dw_bytes=4 * b * oh * ow * c)
    print(f"{net} r{res} block{i:02d} {shape}", flush=True)
    ok = True
    out_b = 4 * b * oh * ow * c_out
    nbytes = 4 * (b * h * w * c + k * k * c + c * c_out) + out_b
    flops = 2 * b * oh * ow * (k * k * c + c * c_out)
    split = _split_bound(sch.splits, b * oh * ow * c_out, nbytes, flops)
    for n, (dw_act, act) in enumerate(acts):
        got, part = tfs.fused_separable_with_partials(
            x, w_dw, w_pw, geo, dw_act=dw_act, act=act)
        if not torch.equal(got, tfs.fused_separable(x, w_dw, w_pw, geo,
                                                    dw_act=dw_act, act=act)):
            print(f"  {net} r{res} block{i:02d} fused_separable does not "
                  "repeat bit for bit: FAIL")
            ok = False
        if part is not None:
            # B4', folded in: exactly act of the split-order sum of the
            # partials this launch wrote; its plain version timed on them
            want = tfs.fused_separable_reduce_plain(part, act=act)
            exact = torch.equal(got, want)
            print(f"  {net} r{res} block{i:02d} fused_separable_reduce "
                  f"folded into fused_separable (act {act}): {sch.splits} "
                  f"splits, output {'exactly' if exact else 'NOT'} act of "
                  f"the split-order sum of its partials")
            ok &= stats.add(
                "fused_separable_reduce", net, res, i, n == 0,
                float((got - want).abs().max()), 0.0,
                hx.times(n == 0, None,
                         lambda p=part, z=act:
                         tfs.fused_separable_reduce_plain(p, act=z)),
                (sch.splits + 1) * out_b, (sch.splits - 1) * out_b // 4,
                good=exact, folded_into="fused_separable", act=act,
                **shape)
        ref = tfs.fused_separable_plain(x, w_dw, w_pw, geo, dw_act=dw_act,
                                        act=act)
        ok &= stats.add(
            "fused_separable", net, res, i, n == 0, *hx.check(got, ref),
            hx.times(n == 0,
                     lambda a=dw_act, z=act: tfs.fused_separable(
                         x, w_dw, w_pw, geo, dw_act=a, act=z),
                     lambda a=dw_act, z=act: tfs.fused_separable_plain(
                         x, w_dw, w_pw, geo, dw_act=a, act=z)),
            nbytes, flops, dw_act=dw_act, act=act, **split, **shape)
    xp = pad_nhwc(x, geo.pads)
    strips = ops.stage_row_strips(xp, k, s, geo.tile_h)
    kw = dict(stride=s, out_w=ow, tile_h=geo.tile_h)
    out = td.dw2d(strips, w_dw, **kw)
    x_nchw, w_oihw = xp.permute(0, 3, 1, 2), w_dw.permute(2, 0, 1)[:, None]
    ok &= stats.add(
        "dw2d", net, res, i, True,
        *hx.check(out, td.dw2d_plain(strips, w_dw, **kw)),
        hx.times(True, lambda: td.dw2d(strips, w_dw, **kw),
                 lambda: td.dw2d_plain(strips, w_dw, **kw),
                 lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, stride=s,
                                                    groups=c)),
        4 * (strips.numel() + k * k * c + out.numel()),
        2 * k * k * out.numel(), strips=tuple(strips.shape), **shape)
    _sync(torch)
    return ok


def _dw2d_bf16_check(torch, td, ops, stats, hx, net, res, i, b, h, w, c,
                     c_out, k, s):
    """The depthwise kernel in bf16 (``dw2d_bf16``: strips, taps and
    output) on one block at the fp32 row's strips (the fp32 schedule's
    tile_h at ``c_out``), at the launch shape ``dw2d_bf16_plan`` solves:
    bit for bit the fp32 kernel's output on the widened values rounded
    once, and within 1 bf16 ulp of the plain version's fp32 sum of the same
    bf16 values; timed beside the plain version and grouped F.conv2d in
    bf16."""
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.kernels.common import spatial_pads
    from repro_torch.kernels.ref import pad_nhwc

    tile_h = get_fused_schedule(b, h, w, c, c_out, k, s).tile_h
    oh, ow, pads = spatial_pads(h, w, k, k, s, "SAME")
    tile_h = min(tile_h, oh)
    xp = pad_nhwc(hx.rand(b, h, w, c).bfloat16(), pads)
    w_dw = hx.rand(k, k, c, scale=1.0 / k).bfloat16()
    strips = ops.stage_row_strips(xp, k, s, tile_h)
    kw = dict(stride=s, out_w=ow, tile_h=tile_h)
    plan = td.dw2d_bf16_plan(b, strips.shape[1], tile_h, ow, c, k, s)
    got = td.dw2d(strips, w_dw, **kw)
    ref = td.dw2d_plain(strips.float(), w_dw.float(), **kw)
    exact = torch.equal(got, td.dw2d(strips.float(), w_dw.float(),
                                     **kw).bfloat16())
    ulps = _bf16_ulps(got, ref)
    good = got.dtype == torch.bfloat16 and ulps <= 1.0 and exact
    x_nchw, w_oihw = xp.permute(0, 3, 1, 2), w_dw.permute(2, 0, 1)[:, None]
    ok = stats.add(
        "dw2d_bf16", net, res, i, net == "mnv2_bf16",
        float((got.float() - ref).abs().max()),
        2.0 ** (int(torch.frexp(ref.abs().max())[1]) - 8),
        hx.times(True, lambda: td.dw2d(strips, w_dw, **kw),
                 lambda: td.dw2d_plain(strips, w_dw, **kw),
                 lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, stride=s,
                                                    groups=c)),
        2 * (strips.numel() + k * k * c + got.numel()),
        2 * k * k * got.numel(), good=good, bf16_ulps=ulps, h=h, w=w,
        c_in=c, k=k, s=s, batch=b, dtype="bfloat16",
        strips=tuple(strips.shape), plan=plan._asdict(),
        grid=td.dw2d_bf16_grid(b, strips.shape[1], tile_h, ow, c, plan),
        exact_fp32_rounded=exact)
    print(f"  {net} block{i:02d} dw2d_bf16: worst {ulps:.3f} bf16 ulp "
          f"(bar 1 ulp), {'exactly' if exact else 'NOT'} the fp32 kernel "
          f"rounded once; plan {tuple(plan)} (run, channels, rows, runs), "
          f"grid "
          f"{td.dw2d_bf16_grid(b, strips.shape[1], tile_h, ow, c, plan)} "
          f"x {plan.threads} threads {'ok' if good else 'FAIL'}")
    _sync(torch)
    return ok


def sep_kernel_phase(torch, tfs, td, ops, stats):
    """Both separable kernels (B4 with its folded split sum) on the 17
    MobileNet-V2 blocks at MNV2_RES, batch BATCH, and on the trainer's 3
    blocks at its batch, the depthwise kernel also in bf16 on the
    trainer's blocks and B4 in bf16 on the 17 blocks; then the 17 blocks
    through ``separable_block``, in fp32, again in bf16, and in bf16 on the
    staged route (``fused=False``: B6 in bf16, each block within the JAX
    suite's bf16 bar of the same route on the CPU on the same bf16
    values), with the launch counts zeroed just before and read just after
    each.  Returns (ok, (fp32 counts, bf16 counts, staged bf16 counts))."""
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.core.workloads import MOBILENET_V2_SEPARABLE
    from repro_torch.examples import train_mobilenet_cim as tr
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.common import separable_block

    hx = _Harness(torch, 3000 + MNV2_RES)
    ok = True
    last = len(MOBILENET_V2_SEPARABLE) - 1
    for i, (layer, c_out) in enumerate(MOBILENET_V2_SEPARABLE):
        acts = [("relu", "relu"), ("relu", None)]
        if i == last:
            acts.append(("relu6", "relu6"))
        ok &= _separable_checks(torch, tfs, td, ops, stats, hx, "mnv2",
                                MNV2_RES, i, BATCH, layer.h, layer.w, layer.c,
                                c_out, layer.k, layer.s, acts)
    side, c = tr.SIDE // 2, tr.model_def()["stem"].shape[-1]
    for i in range(3):
        ok &= _separable_checks(torch, tfs, td, ops, stats, hx, "trainer",
                                tr.SIDE, i, tr.BATCH, side >> i, side >> i,
                                c << i, 2 * c << i, 3, 2, [("relu", "relu")])
    for i in range(3):
        ok &= _dw2d_bf16_check(torch, td, ops, stats, hx, "trainer_bf16",
                               tr.SIDE, i, tr.BATCH, side >> i, side >> i,
                               c << i, 2 * c << i, 3, 2)
    for i, (layer, c_out) in enumerate(MOBILENET_V2_SEPARABLE):
        ok &= _dw2d_bf16_check(torch, td, ops, stats, hx, "mnv2_bf16",
                               MNV2_RES, i, BATCH, layer.h, layer.w, layer.c,
                               c_out, layer.k, layer.s)
        ok &= _separable_bf16_check(torch, tfs, stats, hx, MNV2_RES, i,
                                    BATCH, layer.h, layer.w, layer.c, c_out,
                                    layer.k, layer.s)

    inputs = [(hx.rand(BATCH, layer.h, layer.w, layer.c),
               {"dw": hx.rand(layer.k, layer.k, layer.c, scale=1 / layer.k),
                "pw": hx.rand(layer.c, c_out, scale=layer.c ** -0.5)},
               layer.s) for layer, c_out in MOBILENET_V2_SEPARABLE]
    n_split = sum(get_fused_schedule(BATCH, layer.h, layer.w, layer.c, c_out,
                                     layer.k, layer.s).splits > 1
                  for layer, c_out in MOBILENET_V2_SEPARABLE)
    print(f"  {n_split} of the {len(inputs)} blocks split C_in, each in one "
          f"launch (B4' folded in)")
    with torch.inference_mode():
        reset_launches()                        # the path starts here
        outs = [separable_block(x, p, stride=st)[0] for x, p, st in inputs]
        _sync(torch)
        counts = launches()                     # ... and ends here
    want = {"fused_separable": len(inputs)}
    good = (all(counts[k] == want.get(k, 0) for k in counts)
            and not any(k in counts for k in FOLDED)
            and all(bool(torch.isfinite(o).all()) for o in outs))
    print(f"  the {len(inputs)} MobileNet-V2 blocks through separable_block: "
          f"launches {counts} (want {want}) {'ok' if good else 'FAIL'}")
    # the same blocks in bf16: the bf16 kernel's main path
    inputs16 = [(x.bfloat16(), {k: v.bfloat16() for k, v in p.items()}, st)
                for x, p, st in inputs]
    with torch.inference_mode():
        reset_launches()                        # the bf16 path starts here
        outs16 = [separable_block(x, p, stride=st)[0]
                  for x, p, st in inputs16]
        _sync(torch)
        counts16 = launches()                   # ... and ends here
    want16 = {"fused_separable_bf16": len(inputs)}
    good16 = (all(counts16[k] == want16.get(k, 0) for k in counts16)
              and all(o.dtype == torch.bfloat16
                      and bool(torch.isfinite(o).all()) for o in outs16))
    print(f"  the same blocks in bf16 through separable_block: launches "
          f"{counts16} (want {want16}) {'ok' if good16 else 'FAIL'}")
    # ... and on the staged route: the bf16 depthwise kernel's main path
    with torch.inference_mode():
        reset_launches()                        # the staged path starts here
        outs_st = [separable_block(x, p, stride=st, fused=False)[0]
                   for x, p, st in inputs16]
        _sync(torch)
        counts_st = launches()                  # ... and ends here
    want_st = {"dw2d_bf16": len(inputs)}
    good_st = all(counts_st[k] == want_st.get(k, 0) for k in counts_st)
    worst, worst_err = 0.0, 0.0
    for i, ((x, p, st), o) in enumerate(zip(inputs16, outs_st)):
        with torch.inference_mode():
            cpu = separable_block(x.cpu(), {k: v.cpu() for k, v in p.items()},
                                  stride=st, fused=False)[0]
        err = (o.float().cpu() - cpu.float()).abs()
        ratio = float((err / (BF16_ATOL + BF16_RTOL
                              * cpu.float().abs())).max())
        fine = (o.dtype == torch.bfloat16 and o.shape == cpu.shape
                and bool(torch.isfinite(o).all()) and ratio <= 1.0)
        worst, worst_err = max(worst, ratio), max(worst_err, float(err.max()))
        good_st &= fine
        print(f"  staged bf16 block{i:02d}: max |card - cpu| "
              f"{float(err.max()):.3e}, {ratio:.3f} of the bar (rtol "
              f"{BF16_RTOL}, atol {BF16_ATOL}) {'ok' if fine else 'FAIL'}")
    print(f"  the same blocks in bf16 through separable_block(fused=False): "
          f"launches {counts_st} (want {want_st}); worst {worst_err:.3e}, "
          f"{worst:.3f} of the bar {'ok' if good_st else 'FAIL'}")
    return (bool(ok and good and good16 and good_st),
            (counts, counts16, counts_st))


def _grad_case(torch, name, fn_name, op, plain, args):
    """An op's gradients on the card (its Function: kernel forward, plain
    backward) against autograd through its plain version on the card."""
    leaves = [a.clone().requires_grad_() for a in args]
    out = op(*leaves)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    leaves = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad((plain(*leaves) ** 2).sum(), leaves)
    ok = type(out.grad_fn).__name__ == fn_name
    worst = 0.0
    for g, r in zip(got, want):
        tol = KERNEL_RTOL * float(r.abs().max()) + KERNEL_ATOL
        err = float((g - r).abs().max())
        worst = max(worst, err / tol)
        ok &= err <= tol
    print(f"  {name:44s} grad_fn {type(out.grad_fn).__name__}, "
          f"{len(got)} grads, worst err/tol {worst:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def grad_phase(torch):
    """Each op's gradients on the card against its plain version, full-
    width B0's parameter gradients against the CPU, and B0 forward +
    backward timed."""
    import torch.nn.functional as F
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.core.telemetry import measure
    from repro_torch.core.workloads import MOBILENET_V2_SEPARABLE
    from repro_torch.kernels import (
        convdk_depthwise2d, convdk_fused_separable, convdk_fusedmb_fused,
        convdk_mbconv_fused, launches, reset_launches)
    from repro_torch.kernels.convdk_mbconv import MBConvGeometry
    from repro_torch.kernels.ref import (
        depthwise2d_ref, fusedmb_ref, mbconv_ref, separable_ref)
    from repro_torch.models.mbconv import (
        EffNetConfig, EffNetV2Config, MobileNetV3Config, block_chain_rows,
        block_schedules, efficientnet_b0_apply, efficientnet_b0_def,
        effnet_block_specs, effnet_v2_block_specs, mobilenet_v3_specs)
    from repro_torch.models.param import materialize

    hx = _Harness(torch, 4000)
    ok = True
    # B4 at MobileNet-V2 block 13 (576 -> 160, two c_out tiles), B6 at 3
    layer, c_out = MOBILENET_V2_SEPARABLE[13]
    sch = get_fused_schedule(BATCH, layer.h, layer.w, layer.c, c_out,
                             layer.k, layer.s)
    kw = dict(stride=layer.s, dw_act="relu", act="relu")
    ok &= _grad_case(
        torch, f"fused separable, MobileNet-V2 block 13 b{BATCH}",
        "_FusedSeparableFnBackward",
        lambda *a: convdk_fused_separable(*a, tile_h=sch.tile_h,
                                          tile_w=sch.tile_w, **kw),
        lambda *a: separable_ref(*a, **kw),
        (hx.rand(BATCH, layer.h, layer.w, layer.c),
         hx.rand(3, 3, layer.c, scale=1 / 3),
         hx.rand(layer.c, c_out, scale=layer.c ** -0.5)))
    layer, c_out = MOBILENET_V2_SEPARABLE[3]
    sch = get_fused_schedule(BATCH, layer.h, layer.w, layer.c, c_out,
                             layer.k, layer.s)
    ok &= _grad_case(
        torch, f"depthwise, MobileNet-V2 block 3 b{BATCH}",
        "_DepthwiseFnBackward",
        lambda *a: convdk_depthwise2d(*a, stride=layer.s,
                                      tile_h=sch.tile_h),
        lambda *a: depthwise2d_ref(*a, layer.s),
        (hx.rand(BATCH, layer.h, layer.w, layer.c),
         hx.rand(3, 3, layer.c, scale=1 / 3)))

    def mbconv_case(net, specs, res, i, modes):
        sp = specs[i]
        h, w, c_in, c_mid, c_out, k, s = block_chain_rows(
            specs, -(-res // 2), -(-res // 2))[i][:7]
        acts = dict(exp_act=sp.act, dw_act=sp.act)
        se = dict(se_act=sp.se_act, gate_act=sp.gate_act)
        args = [hx.rand(BATCH, h, w, c_in),
                hx.rand(c_in, c_mid, scale=c_in ** -0.5),
                hx.rand(k, k, c_mid, scale=1 / k)]
        if sp.has_se:
            args += [hx.rand(c_mid, sp.c_se, scale=c_mid ** -0.5),
                     hx.rand(sp.c_se, scale=0.1),
                     hx.rand(sp.c_se, c_mid, scale=sp.c_se ** -0.5),
                     hx.rand(c_mid, scale=0.1)]
        args.append(hx.rand(c_mid, c_out, scale=c_mid ** -0.5))
        n_se = 4 if sp.has_se else 0
        good = True
        for mode in modes:
            # each mode at the tile the forward solves when pinned to it
            sch = block_schedules(specs, BATCH, res, res, mode=mode)[i]

            def op(*a, m=mode, sch=sch):
                x, w_exp, w_dw, *rest = a
                se_w = rest[:n_se] if n_se else [None] * 4
                return convdk_mbconv_fused(
                    x, w_exp, w_dw, *se_w, rest[-1], stride=s,
                    tile_h=sch.tile_h, tile_w=sch.tile_w, mode=m, **acts,
                    **se)

            def plain(*a):
                x, w_exp, w_dw, *rest = a
                se_w = rest[:n_se] if n_se else [None] * 4
                return mbconv_ref(x, w_exp, w_dw, *se_w, rest[-1], stride=s,
                                  **acts, **se)

            good &= _grad_case(
                torch, f"MBConv {mode}{' + SE' if sp.has_se else ', no SE'}, "
                       f"{net} block {i} b{BATCH}", "_MBConvFnBackward", op,
                plain, args)
        return good

    ok &= mbconv_case("B0", effnet_block_specs(EffNetConfig()), RES, 3,
                      ("retain", "recompute"))
    v3 = mobilenet_v3_specs(MobileNetV3Config())
    i_v3 = next(i for i, sp in enumerate(v3)
                if not sp.has_se and sp.c_mid != sp.c_in)
    ok &= mbconv_case("V3", v3, V3_RES, i_v3, ("retain",))
    v2s = effnet_v2_block_specs(EffNetV2Config())
    i_v2 = next(i for i, sp in enumerate(v2s)
                if sp.family == "fusedmb" and sp.s == 2)
    h, w, c_in, c_mid, c_out, k, s = block_chain_rows(
        v2s, -(-V2S_RES // 2), -(-V2S_RES // 2))[i_v2][:7]
    sch = block_schedules(v2s, BATCH, V2S_RES, V2S_RES)[i_v2]
    ok &= _grad_case(
        torch, f"Fused-MBConv, V2-S block {i_v2} b{BATCH}",
        "_FusedMBFnBackward",
        lambda *a: convdk_fusedmb_fused(*a, stride=s, tile_h=sch.tile_h,
                                        tile_w=sch.tile_w, act="silu"),
        lambda *a: fusedmb_ref(*a, s, "SAME", "silu"),
        (hx.rand(BATCH, h, w, c_in),
         hx.rand(k, k, c_in, c_mid, scale=(k * k * c_in) ** -0.5),
         hx.rand(c_mid, c_out, scale=c_mid ** -0.5)))

    # full-width B0: every parameter's gradient on the card vs the CPU
    cfg = EffNetConfig()
    params = materialize(efficientnet_b0_def(cfg),
                         torch.Generator().manual_seed(0), DEVICE)
    params_cpu = _cpu_tree(torch, params)
    names = sorted(_flat_tree(params))
    images = torch.rand(BATCH, RES, RES, 3,
                        generator=torch.Generator().manual_seed(1))
    labels = torch.randint(0, cfg.num_classes, (BATCH,),
                           generator=torch.Generator().manual_seed(2))

    def grads(tree, x, y):
        # fresh leaves per call, so each call's AccumulateGrad nodes live
        # on the stream it runs on (measure() warms up on a side stream)
        tree = _fresh_leaves(tree)
        flat = _flat_tree(tree)
        loss = F.cross_entropy(efficientnet_b0_apply(tree, x, cfg), y)
        return loss, torch.autograd.grad(loss, [flat[n] for n in names])

    n = GRAD_CPU_IMAGES
    reset_launches()
    loss, got = grads(params, images[:n].to(DEVICE), labels[:n].to(DEVICE))
    _sync(torch)
    counts = launches()
    loss_cpu, want = grads(params_cpu, images[:n], labels[:n])
    worst, bad = 0.0, []
    for name, g, r in zip(names, got, want):
        err = float((g.cpu() - r).abs().max())
        tol = GRAD_RTOL * float(r.abs().max())
        worst = max(worst, err / tol if tol else float(err > 0))
        if err > tol:
            bad.append(name)
    good = not bad and counts["mbconv_pass1"] > 0
    print(f"  B0 {RES}x{RES} batch {n}, 1000 classes: loss card "
          f"{loss.item():.6f} cpu {loss_cpu.item():.6f}; {len(names)} "
          f"parameter gradients vs the CPU plain run, worst err/tol "
          f"{worst:.3e} (tol {GRAD_RTOL:g} x max|cpu grad|) "
          f"{'ok' if good else 'FAIL ' + str(bad[:5])}; launches {counts}")
    ok &= good

    x8, y8 = images.to(DEVICE), labels.to(DEVICE)
    fwd_bwd = measure(lambda: grads(params, x8, y8), iters=10, warmup=2)
    print(f"  B0 forward + backward ({RES}x{RES}, batch {BATCH}): "
          f"{fwd_bwd.mean_ms:.3f} ms (CUDA events, mean of 10)")
    trace = trace_phase(torch, lambda: grads(params, x8, y8),
                        fwd_bwd.mean_ms, grad=True)
    return bool(ok), {"forward_backward_ms": fwd_bwd.mean_ms,
                      "trace": trace}


def _fresh_leaves(tree):
    """The same tree with each tensor detached, requiring grad."""
    return {k: _fresh_leaves(v) if isinstance(v, dict)
            else v.detach().requires_grad_() for k, v in tree.items()}


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def train_phase(torch):
    """The trainer on the card under deterministic algorithms (the cuDNN
    flags restored after): TRAIN_STEPS fused steps twice, then
    STAGED_STEPS --staged steps, each run with the launch counts zeroed
    just before and read just after, each against a TRAIN_CPU_STEPS CPU
    plain run; then one step of each route timed."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    try:
        return _train_runs(torch)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        torch.use_deterministic_algorithms(False)


def _train_runs(torch):
    from repro_torch.core.autotune import get_fused_schedule
    from repro_torch.core.telemetry import measure
    from repro_torch.examples import train_mobilenet_cim as tr
    from repro_torch.kernels import launches, reset_launches

    # the trainer's blocks never split C_in (C_out = 2 C_in)
    side, c = tr.SIDE // 2, tr.model_def()["stem"].shape[-1]
    splits = sum(get_fused_schedule(tr.BATCH, side >> i, side >> i, c << i,
                                    2 * c << i, 3, 2).splits > 1
                 for i in range(3))
    runs = []
    for staged, steps in ((False, TRAIN_STEPS), (False, TRAIN_STEPS),
                          (True, STAGED_STEPS)):
        argv = ["--steps", str(steps), "--device", DEVICE] + (
            ["--staged"] if staged else [])
        buf = io.StringIO()
        reset_launches()                        # the main path starts here
        with contextlib.redirect_stdout(buf):
            losses = tr.main(argv)
        _sync(torch)
        counts = launches()                     # ... and ends here
        print("  " + buf.getvalue().strip().replace("\n", "\n  "))
        print(f"  launches {counts}")
        runs.append((losses, counts, buf.getvalue()))
    (fused, f_counts, f_out), (again, a_counts, _) = runs[0], runs[1]
    staged, s_counts, _ = runs[2]
    want_f = {"fused_separable": 3 * TRAIN_STEPS}
    want_s = {"dw2d": 3 * STAGED_STEPS}
    ok = splits == 0 and not any(k in f_counts for k in FOLDED)
    ok &= all(f_counts[k] == a_counts[k] == want_f.get(k, 0) for k in f_counts)
    ok &= all(s_counts[k] == want_s.get(k, 0) for k in s_counts)
    print(f"  launches per step: fused {3} fused separable ({splits} split "
          f"blocks); staged 3 depthwise: {'ok' if ok else 'FAIL'}")
    same = fused == again
    ok &= same
    print(f"  two fused {TRAIN_STEPS}-step runs: losses bit for bit equal "
          f"{'ok' if same else 'FAIL'}")
    ratio = fused[-1] / fused[0]
    print(f"  fused step {TRAIN_STEPS} / step 1 loss {ratio:.4f} "
          f"({'DESCENDED' if '(DESCENDED)' in f_out else 'check'}; the "
          f"0.7 bar reads one step of a chaotic trajectory and gates only "
          f"the CPU test)")
    # the same run on the CPU through the plain versions: step 1 is one
    # forward on the same weights, later steps drift with the rounding
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = tr.main(["--steps", str(TRAIN_CPU_STEPS), "--device", "cpu"])
    for name, losses in (("fused", fused), ("staged", staged)):
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, cpu)]
        good = (len(rel) == TRAIN_CPU_STEPS and rel[0] <= 1e-5
                and max(rel) <= TRAIN_RTOL)
        ok &= good
        print(f"  {name} on the card vs the CPU plain run: step 1 rel "
              f"{rel[0]:.3e} (tol 1e-05), steps 1-{TRAIN_CPU_STEPS} largest "
              f"rel {max(rel):.3e} (tol {TRAIN_RTOL:g}) "
              f"{'ok' if good else 'FAIL'}")
    rel1 = abs(fused[0] - staged[0]) / abs(fused[0])
    ok &= rel1 <= 1e-5
    print(f"  step 1 loss fused {fused[0]!r} staged {staged[0]!r}: rel "
          f"{rel1:.3e} (tol 1e-05)")
    params = tr.init_params(DEVICE)
    x, y = tr.batch(0, DEVICE)
    step_ms = {route: measure(lambda f=f: tr.sgd_step(params, x, y, fused=f),
                              iters=10, warmup=2).mean_ms
               for route, f in (("fused", True), ("staged", False))}
    print(f"  one SGD step at batch {tr.BATCH} (CUDA events, mean of 10, "
          f"host included): fused {step_ms['fused']:.3f} ms, staged "
          f"{step_ms['staged']:.3f} ms")
    print(f"  train phase {'ok' if ok else 'FAIL'}")
    return bool(ok), {"fused_separable": f_counts["fused_separable"],
                      "dw2d": s_counts["dw2d"]}, \
        {"fused": fused, "staged": staged, "cpu": cpu, "step_ms": step_ms,
         "fused_repeats": same}


def _bf16_ulp(ref32):
    """One bf16 ulp of each element of ``ref32`` (the spacing of bf16
    numbers at its binade; 2^-133 at 0)."""
    import torch
    _, exp = torch.frexp(ref32)
    return torch.where(ref32 == 0, torch.full_like(ref32, 2.0 ** -133),
                       torch.ldexp(torch.ones_like(ref32), exp - 8))


def _bf16_ulps(got, ref):
    """Largest |got - ref| in units of one bf16 ulp of ``ref``."""
    ref32 = ref.float()
    return float(((got.float() - ref32).abs() / _bf16_ulp(ref32)).max())


def _conv1d_checks(torch, tc, stats, hx, net, b, seq, convs, k,
                   act) -> bool:
    """The conv1d kernel on each ``(name, D)`` of ``convs`` at batch ``b``
    x ``seq`` (bias, activation ``act``) against its plain version, in
    bf16 (the main path's type: within 1 bf16 ulp per element; timed) and
    in fp32 (the phase-2 bar), and in both bit for bit (``torch.equal``);
    the library yardstick is grouped F.conv1d on a channels-first copy
    made outside the timed region (then F.silu where ``act`` is SiLU).
    Each row carries its launch plan and the plan's modelled bytes
    requested ahead (``conv1d_plan``, ``plan_info``: arithmetic, not
    measured), the resident CTAs per SM the occupancy calculator gives its
    instance (at least the plan's RESIDENT_CTAS) and its share of the
    bound; bytes and operations are ``conv1d_cost``'s.  Rows under ``net``
    at ``res`` = ``seq``."""
    import torch.nn.functional as F

    ok = True
    n_sm = tc.sm_count(torch.cuda.current_device())
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, d) in enumerate(convs):
            x = hx.rand(b, seq, d).to(dtype)
            w = hx.rand(k, d, scale=0.5)
            bias = hx.rand(d, scale=0.1)
            got = tc.conv1d(x, w, bias, act)
            ref = tc.conv1d_plain(x, w, bias, act)
            exact = bool(torch.equal(got, ref))
            err = float((got.float() - ref.float()).abs().max())
            if dtype == torch.float32:
                _, tol = hx.check(got, ref)
                good, bar = None, {}
            else:
                # the bar is 1 ulp per element; tol shows the ulp at the
                # largest |plain| value
                ulps = _bf16_ulps(got, ref)
                tol = 2.0 ** (int(torch.frexp(ref.float().abs().max())[1]) - 8)
                good, bar = ulps <= 1.0, {"bf16_ulps": ulps}
                print(f"  {name} bf16 at {b} x {seq}: worst {ulps:.3f} bf16 "
                      f"ulp (bar 1 ulp)")
            xt = x.transpose(1, 2).contiguous()
            w_lib = w.t().unsqueeze(1).to(dtype)
            b_lib = bias.to(dtype)

            def library(xt=xt, w_lib=w_lib, b_lib=b_lib, d=d):
                y = F.conv1d(xt, w_lib, b_lib, padding=k - 1,
                             groups=d)[..., :seq]
                return F.silu(y) if act == "silu" else y

            elt = x.element_size()
            plan = tc.plan_info(tc.conv1d_plan(b, seq, d, elt, n_sm), seq, d,
                                k, elt, n_sm)
            resident = tc._lib().conv1d_resident_ctas(
                k, int(dtype == torch.bfloat16), int(d % (16 // elt) == 0))
            good = (err <= tol if good is None else good) and exact \
                and resident >= tc.RESIDENT_CTAS
            ok &= stats.add(
                "conv1d", net, seq, i, dtype == torch.bfloat16, err, tol,
                hx.times(True,
                         lambda: tc.conv1d(x, w, bias, act),
                         lambda: tc.conv1d_plain(x, w, bias, act), library),
                *tc.conv1d_cost(b, seq, d, k, elt, act), good=good, conv=name, d=d, k=k,
                batch=b, dtype=str(dtype).split(".")[-1], exact=exact,
                resident_ctas=resident, **plan, **bar)
            row = stats.rows[-1]
            print(f"  {name} {str(dtype).split('.')[-1]} at {b} x {seq}: "
                  f"bit for bit {exact}; plan {plan['ctas']} CTAs "
                  f"({plan['waves']:.2f} waves of {n_sm} x "
                  f"{tc.RESIDENT_CTAS}, last {plan['wave_fill']:.1%} full), "
                  f"walk {plan['walk']}, modelled "
                  f"{plan['modeled_bytes_requested_ahead'] / 1e6:.2f} MB "
                  f"requested ahead, halo {plan['halo_share']:.1%} of "
                  f"the loads, resident CTAs/SM {resident}; "
                  f"{row['ms']:.4f} ms, {row['bound_ms'] / row['ms']:.1%} "
                  f"of its bound")
            del x, got, ref, xt
    _sync(torch)
    return bool(ok)


def lm_kernel_phase(torch, tc, stats) -> bool:
    """The conv1d kernel on every conv of a Mamba-2 2.7B layer at batch 1
    x LM_TOKENS (k 4, SiLU, bias) against its plain version
    (``_conv1d_checks``)."""
    return _conv1d_checks(torch, tc, stats, _Harness(torch, 5000), "mamba2",
                          1, LM_TOKENS, LM_CONVS, 4, "silu")


def _card_generator(torch, seed):
    """A seeded generator on DEVICE: the full-width LM trees draw their
    weights on the card (seconds, where a CPU generator takes 8.6 ns a
    parameter); every check they feed is on the card or on a copy of their
    first layers moved to the CPU, so their numbers need not match a CPU
    generator's."""
    return torch.Generator(device=DEVICE).manual_seed(seed)


def lm_init(torch):
    """Full-width Mamba-2 2.7B, fp32 weights from a seeded generator on the
    card, materialized once for the LM phases."""
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.models.model import model_def
    from repro_torch.models.param import count_params, materialize

    t0 = time.perf_counter()
    params = materialize(model_def(CONFIG), _card_generator(torch, 0), DEVICE)
    _sync(torch)
    n = count_params(params)
    print(f"  Mamba-2 2.7B ({CONFIG.n_layers} layers, d_model "
          f"{CONFIG.d_model}): {n} parameters, {4 * n / 1e9:.2f} GB fp32, "
          f"materialized in {time.perf_counter() - t0:.1f} s")
    return params


def _first_layers(tree, n):
    """The model with its first ``n`` stacked layers (views)."""
    if isinstance(tree, dict):
        return {k: v if k in ("embed", "final_norm", "head")
                else _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _rel(got, ref):
    """max|got - ref| / max|ref|, on ``got``'s device (the logits are
    GBs)."""
    ref = ref.to(got.device)
    return float((got.float() - ref.float()).abs_().max()) \
        / float(ref.float().abs().max())


def lm_model_phase(torch, params):
    """The prefill forward at full width: launch counts of the kernel and
    plain paths, fp32 kernel vs plain on the card, a 2-layer copy vs the
    CPU, then the bf16 prefill step at 1 x LM_TOKENS timed and traced."""
    import dataclasses
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.core.telemetry import measure
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.model import forward
    from repro_torch.train.step import make_prefill_step

    per_forward = len(LM_CONVS) * CONFIG.n_layers
    gen = torch.Generator().manual_seed(6)
    ok = True
    f32 = dataclasses.replace(CONFIG, dtype="float32")
    with torch.inference_mode():
        tokens = torch.randint(0, CONFIG.vocab, LM_CHECK, generator=gen)
        out = {}
        for kernel in (True, False):
            cfg = dataclasses.replace(f32, use_convdk_kernel=kernel)
            reset_launches()                    # the main path starts here
            out[kernel] = forward(params, {"tokens": tokens.to(DEVICE)}, cfg)
            _sync(torch)
            counts = launches()                 # ... and ends here
            want = per_forward if kernel else 0
            good = (counts["conv1d"] == want
                    and not any(v for k, v in counts.items()
                                if k != "conv1d"))
            print(f"  fp32 forward {LM_CHECK[0]} x {LM_CHECK[1]}, kernel "
                  f"{kernel}: logits {tuple(out[kernel].shape)}, launches "
                  f"{counts} (want {want} conv1d) {'ok' if good else 'FAIL'}")
            ok &= good
        rel = _rel(out[True], out[False])
        good = (bool(torch.isfinite(out[True]).all()) and rel <= MODEL_RTOL
                and out[True].shape == (*LM_CHECK, CONFIG.vocab))
        print(f"  kernel path vs plain path on the card: rel err {rel:.3e} "
              f"(tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
        ok &= good
        del out

        two = dataclasses.replace(f32, n_layers=2, use_convdk_kernel=True)
        p2 = _first_layers(params, 2)
        tokens = torch.randint(0, CONFIG.vocab, LM_CPU, generator=gen)
        got = forward(p2, {"tokens": tokens.to(DEVICE)}, two)
        ref = forward(_cpu_tree(torch, p2), {"tokens": tokens}, two)
        rel = _rel(got, ref)
        good = bool(torch.isfinite(got).all()) and rel <= MODEL_RTOL
        print(f"  2-layer full-width copy, {LM_CPU[0]} x {LM_CPU[1]}, vs the "
              f"CPU plain run: max|cpu| {float(ref.abs().max()):.4e} rel err "
              f"{rel:.3e} (tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
        ok &= good
        del got, ref, p2

        cfg = dataclasses.replace(CONFIG, use_convdk_kernel=True)   # bf16
        step = make_prefill_step(cfg)
        batch = {"tokens": torch.randint(0, CONFIG.vocab, (1, LM_TOKENS),
                                         generator=gen).to(DEVICE)}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                        # the main path starts here
        nxt = step(params, batch)
        _sync(torch)
        counts = launches()                     # ... and ends here
        good = (counts["conv1d"] == per_forward and nxt.shape == (1,)
                and 0 <= int(nxt) < CONFIG.vocab)
        print(f"  bf16 prefill step 1 x {LM_TOKENS}: next token "
              f"{int(nxt)}, launches {counts} (want {per_forward} conv1d), "
              f"peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        fwd = measure(lambda: step(params, batch), iters=3, warmup=1)
    print(f"  bf16 prefill step (1 x {LM_TOKENS}): {fwd.mean_ms:.3f} ms "
          f"(CUDA events, mean of 3), {LM_TOKENS / fwd.mean_ms * 1e3:.0f} "
          f"tokens/s")
    trace = trace_phase(torch, lambda: step(params, batch), fwd.mean_ms)
    return bool(ok), counts, {"prefill_ms": fwd.mean_ms, "trace": trace}


def _engine_phase(torch, cfg, params, requests=LM_REQUESTS,
                  new_tokens=LM_NEW_TOKENS, check=None):
    """The LM engine serving ``cfg`` (bf16) at full width on ``requests``
    (prompt lengths; LITTLE below LM_LITTLE) with ``new_tokens`` each,
    then in fp32 (and the fields of ``check``) its decode-loop prefill of
    2 x 32 tokens against the forward's last row."""
    import dataclasses
    import numpy as np
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.model import forward, init_decode_state
    from repro_torch.serve import Engine, ServeConfig

    eng = Engine(cfg, params, ServeConfig(max_new_tokens=new_tokens,
                                          little_threshold=LM_LITTLE),
                 device=DEVICE)
    spent = {"prefill": 0.0, "decode": 0.0}
    work = {"prefill": 0, "decode": 0}

    def timed(fn, key, count):
        def wrapper(*args):
            _sync(torch)
            t = time.perf_counter()
            out = fn(*args)
            _sync(torch)
            spent[key] += time.perf_counter() - t
            work[key] += count(*args)
            return out
        return wrapper

    eng.prefill = timed(eng.prefill, "prefill", lambda tok, st: tok.numel())
    eng._step = timed(eng._step, "decode", lambda st, tok, g: tok.numel())
    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, cfg.vocab, n).astype(np.int32)
            for n in requests]
    batches = eng.schedule(reqs)
    reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate_many(reqs)
    _sync(torch)
    wall = time.perf_counter() - t0
    counts = launches()
    ok = (len(outs) == len(reqs)
          and all(o.shape == (new_tokens,) and (o >= 0).all()
                  and (o < cfg.vocab).all() for o in outs))
    stats = {"wall_s": wall, "batches": batches,
             "prefill_tokens": work["prefill"],
             "prefill_tokens_per_s": work["prefill"] / spent["prefill"],
             "decode_tokens": work["decode"],
             "decode_ms_per_token": spent["decode"] / work["decode"] * 1e3,
             "decode_steps_s": spent["decode"], "launches": counts,
             "decode_tokens_per_s": work["decode"] / spent["decode"]}
    print(f"  {len(reqs)} requests ({', '.join(map(str, requests))} "
          f"tokens) in batches {batches}: all answered "
          f"{'ok' if ok else 'FAIL'} in {wall:.2f} s; launches {counts}")
    print(f"  prefill {work['prefill']} tokens (padded) in "
          f"{spent['prefill']:.2f} s: {stats['prefill_tokens_per_s']:.1f} "
          f"tokens/s; decode {work['decode']} tokens in "
          f"{spent['decode']:.2f} s: {stats['decode_ms_per_token']:.2f} ms "
          f"per token (host clock, synchronized)")
    # the timed wrappers hold the engine's bound methods: drop them, or the
    # cycle keeps the engine and its weights alive past the phase
    del eng.prefill, eng._step

    f32 = dataclasses.replace(cfg, dtype="float32", **(check or {}))
    eng32 = Engine(f32, params, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab, (2, 32),
                           generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        state = init_decode_state(f32, 2, 32, torch.float32, DEVICE)
        _, last = eng32.prefill(tokens.to(DEVICE), state)
        full = forward(params, {"tokens": tokens.to(DEVICE)}, f32)[:, -1]
    rel = _rel(last, full)
    good = bool(torch.isfinite(last).all()) and rel <= MODEL_RTOL
    print(f"  fp32 decode-loop prefill of 2 x 32 tokens vs the forward"
          f"{''.join(f', {k} {v}' for k, v in (check or {}).items())}: rel "
          f"err {rel:.3e} (tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
    return bool(ok and good), dict(stats, fp32_prefill_rel_err=rel)


def lm_serve_phase(torch, params):
    """The engine at full width in bf16 on LM_REQUESTS (the conv1d kernel's
    path), then its fp32 decode-loop prefill against the kernel path's
    forward."""
    import dataclasses
    from repro_torch.configs.mamba2_2p7b import CONFIG

    return _engine_phase(
        torch, dataclasses.replace(CONFIG, use_convdk_kernel=True), params)


def _lm_batches(torch, dcfg, n):
    """The first ``n`` batches of the synthetic stream, on DEVICE."""
    from repro_torch.data.pipeline import DataState, make_batch

    state, out = DataState(seed=dcfg.seed, step=0), []
    for _ in range(n):
        batch, state = make_batch(dcfg, state)
        out.append({k: torch.from_numpy(v).to(DEVICE)
                    for k, v in batch.items()})
    return out


def _lm_steps(torch, cfg, tcfg, params, batches):
    """make_train_step's steps on ``params`` (updated in place), one per
    batch: (loss, grad norm, launch counts) each, the counts zeroed just
    before the step and read just after."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.train.step import make_train_step

    init_opt, step = make_train_step(cfg, tcfg)
    opt, out = init_opt(params), []
    for batch in batches:
        reset_launches()                        # the main path starts here
        _, _, m = step(params, opt, batch)
        _sync(torch)
        out.append((float(m["loss"]), float(m["grad_norm"]), launches()))
    return out


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _only_conv1d(counts, want):
    return counts["conv1d"] == want and not any(
        v for k, v in counts.items() if k != "conv1d")


def _lm_train_parity(torch, params, tcfg, per_step):
    """fp32 at LM_TRAIN_CHECK: two steps on each route from its own copy of
    the weights, the parameter deltas compared; then whether a second
    kernel-route run repeats its losses."""
    import dataclasses
    import math
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.param import _map
    from repro_torch.train.checkpoint import _leaf_names

    f32 = dataclasses.replace(CONFIG, dtype="float32")
    dcfg = DataConfig(vocab=CONFIG.vocab, seq_len=LM_TRAIN_CHECK[1],
                      global_batch=LM_TRAIN_CHECK[0])
    batches = _lm_batches(torch, dcfg, 2)
    before = _leaf_names(params)
    ok, runs, deltas = True, {}, {}
    for kernel in (True, False):
        cfg = dataclasses.replace(f32, use_convdk_kernel=kernel)
        p = _map(params, lambda t: t.clone())
        t0 = time.perf_counter()
        runs[kernel] = _lm_steps(torch, cfg, tcfg, p, batches)
        secs = time.perf_counter() - t0
        for name, d in _leaf_names(p).items():
            d.sub_(before[name])
        deltas[kernel] = p
        del p
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        want = per_step if kernel else 0
        for i, (loss, gnorm, counts) in enumerate(runs[kernel]):
            good = _only_conv1d(counts, want) and math.isfinite(loss)
            print(f"  fp32 step {i + 1} ({LM_TRAIN_CHECK[0]} x "
                  f"{LM_TRAIN_CHECK[1]}), kernel route {kernel}: loss "
                  f"{loss:.6f} grad norm {gnorm:.6f}, launches "
                  f"{_nonzero(counts)} (want {want} conv1d) "
                  f"{'ok' if good else 'FAIL'}")
            ok &= good
        print(f"  two fp32 steps, kernel route {kernel}: {secs:.1f} s")
    for i, (k, pl) in enumerate(zip(runs[True], runs[False])):
        rel = [abs(a - b) / abs(b) for a, b in zip(k[:2], pl[:2])]
        good = max(rel) <= LM_DELTA_RTOL
        print(f"  step {i + 1} kernel vs plain route: loss rel diff "
              f"{rel[0]:.3e}, grad norm rel diff {rel[1]:.3e} (tol "
              f"{LM_DELTA_RTOL:g}) {'ok' if good else 'FAIL'}")
        ok &= good
    plain = _leaf_names(deltas.pop(False))
    scale = max(float(d.abs().max()) for d in plain.values())
    first = _leaf_names(deltas.pop(True))
    errs = {name: float((d - plain[name]).abs_().max())
            for name, d in first.items()}
    worst = max(errs, key=errs.get)
    rel = errs[worst] / scale
    good = rel <= LM_DELTA_RTOL and scale > 0
    print(f"  parameter deltas after 2 steps, kernel vs plain route: max|err| "
          f"{errs[worst]:.4e} ({worst}) at max|plain delta| {scale:.4e}: rel "
          f"{rel:.3e} (tol {LM_DELTA_RTOL:g}) {'ok' if good else 'FAIL'}")
    ok &= good
    del plain
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # the repeat: its losses and, leaf by leaf in JAX's order, its deltas
    # against the first kernel-route run's; the first leaf that differs
    # names the op that writes it
    p = _map(params, lambda t: t.clone())
    again = _lm_steps(torch, dataclasses.replace(f32, use_convdk_kernel=True),
                      tcfg, p, batches)
    differs = next((name for name, d in _leaf_names(p).items()
                    if not torch.equal(d.sub_(before[name]), first[name])),
                   None)
    del p, first
    repeats = [r[0] for r in again] == [r[0] for r in runs[True]]
    print(f"  a second kernel-route run repeats the losses bit for bit: "
          f"{repeats} ({[r[0] for r in again]}); its parameter deltas "
          f"{'too' if differs is None else 'differ first at ' + differs}")
    return bool(ok), {
        "fp32_losses": {f"kernel={k}": [r[0] for r in v]
                        for k, v in runs.items()},
        "fp32_grad_norms": {f"kernel={k}": [r[1] for r in v]
                            for k, v in runs.items()},
        "delta_rel_err": rel, "delta_worst_leaf": worst,
        "delta_scale": scale, "repeats_bit_for_bit": repeats,
        "deltas_first_differ_at": differs}


def lm_train_phase(torch, tc, stats, params):
    """The LM training step on the full-width Mamba-2 tree (left as it
    was): the conv1d kernel at the bf16 step's shapes, fp32 parity of the
    kernel and plain routes, the bf16 Trainer.run and its weights' loss and
    gradients on both routes, and a checkpoint resume at 2 layers."""
    import dataclasses
    import math
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.core.telemetry import measure
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.train import Trainer
    from repro_torch.models.param import _map
    from repro_torch.train.checkpoint import _leaf_names
    from repro_torch.train.optim import OptimConfig, make_optimizer
    from repro_torch.train.step import TrainConfig

    per_step = 2 * len(LM_CONVS) * CONFIG.n_layers      # forward + recompute
    tcfg = TrainConfig(optim=OptimConfig(**LM_TRAIN_OPTIM))
    b, seq = LM_TRAIN_BATCH
    marks = [time.perf_counter()]
    ok = _conv1d_checks(torch, tc, stats, _Harness(torch, 5100),
                        "mamba2_train", b, seq, LM_CONVS, 4, "silu")
    good, info = _lm_train_parity(torch, params, tcfg, per_step)
    ok &= good
    marks.append(time.perf_counter())

    # the bf16 main path through the entry point
    cfg = dataclasses.replace(CONFIG, use_convdk_kernel=True)
    dcfg = DataConfig(vocab=CONFIG.vocab, seq_len=seq, global_batch=b)
    held = torch.cuda.memory_allocated() / 1e9  # the lm phases' own tree
    t0 = time.perf_counter()
    tr = Trainer(cfg, tcfg, dcfg, device=DEVICE)
    _sync(torch)
    init_s = time.perf_counter() - t0
    print(f"  Trainer at full width (bf16 activations, fp32 params and AdamW "
          f"state): materialized from the CPU generator in {init_s:.1f} s")
    events, real_step = [], tr.train_step

    def timed(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real_step(*args)
        end.record()
        events.append((start, end))
        return out

    tr.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reset_launches()                            # the main path starts here
    losses = tr.run(LM_TRAIN_STEPS, ckpt_every=0, log_every=1)
    _sync(torch)
    counts = launches()                         # ... and ends here
    run_s = time.perf_counter() - t0
    tr.train_step = real_step
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = [a.elapsed_time(b) for a, b in events]
    step_ms = sum(ms[1:]) / len(ms[1:])
    good = (_only_conv1d(counts, per_step * LM_TRAIN_STEPS)
            and len(losses) == LM_TRAIN_STEPS
            and all(math.isfinite(x) for x in losses))
    print(f"  bf16 Trainer.run, {LM_TRAIN_STEPS} steps at {b} x {seq} in "
          f"{run_s:.1f} s: losses {losses}, launches {_nonzero(counts)} "
          f"(want {per_step * LM_TRAIN_STEPS} conv1d) "
          f"{'ok' if good else 'FAIL'}")
    print(f"  step on CUDA events {', '.join(f'{x:.1f}' for x in ms)} ms; "
          f"steps 2-{LM_TRAIN_STEPS} {step_ms:.1f} ms: "
          f"{b * seq / step_ms * 1e3:.0f} tokens/s; peak {peak:.1f} GB, "
          f"{peak - held:.1f} GB above the {held:.1f} GB held before the "
          f"Trainer")
    ok &= good
    batch = _lm_batches(torch, dcfg, 1)[0]
    good, info["bf16_routes"] = _lm_bf16_routes(torch, cfg, tr.params, batch)
    ok &= good
    t0 = time.perf_counter()
    trace = trace_phase(
        torch, lambda: tr.train_step(tr.params, tr.opt_state, batch),
        step_ms, grad=True, calls=1)
    print(f"  the trace of one step took {time.perf_counter() - t0:.1f} s")
    _, update = make_optimizer(tcfg.optim)
    grads = _map(tr.params, torch.zeros_like)
    opt_ms = measure(lambda: update(grads, tr.opt_state, tr.params),
                     iters=2, warmup=1).mean_ms
    print(f"  the optimizer's update alone (AdamW over "
          f"{sum(t.numel() for t in _leaf_names(tr.params).values())} fp32 "
          f"parameters): {opt_ms:.1f} ms on CUDA events, "
          f"{opt_ms / step_ms:.1%} of a step")
    info.update(trainer_init_s=init_s, losses=losses, step_ms=step_ms,
                tokens_per_s=b * seq / step_ms * 1e3, peak_gb=peak,
                held_gb=held,
                optimizer_ms=opt_ms, trace=trace, launches=counts)
    del tr, grads, batch
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    marks.append(time.perf_counter())
    good, info["resume"] = _lm_resume(torch, cfg, tcfg)
    ok &= good
    marks.append(time.perf_counter())
    info["seconds"] = dict(zip(("parity", "trainer", "resume"),
                               (b - a for a, b in zip(marks, marks[1:]))))
    print(f"  lm-train seconds: {info['seconds']}")
    return bool(ok), counts["conv1d"] // LM_TRAIN_STEPS, info


def _lm_bf16_routes(torch, cfg, params, batch):
    """One bf16 loss and gradient (no update) from the trained weights at
    LM_TRAIN_BATCH on the kernel route, against the same route with the
    kernel's plain version (``conv1d_plain``) in its place: losses and
    gradient norms within LM_BF16_ROUTE_RTOL, B7 launched 2 x 3 x 64 times
    on the kernel route and never in the other run.  The model's plain
    route (bf16 taps, every partial sum rounded to bf16, as the JAX
    package's reference) rounds the same conv differently; it is printed
    beside them, not gated."""
    import dataclasses
    from unittest import mock
    from repro_torch.kernels import convdk_conv1d, launches, ops, \
        reset_launches
    from repro_torch.train.optim import global_norm
    from repro_torch.train.step import loss_and_grads

    def run(kernel):
        reset_launches()
        loss, grads = loss_and_grads(
            params, batch, dataclasses.replace(cfg, use_convdk_kernel=kernel))
        return float(loss), float(global_norm(grads)), launches()["conv1d"]

    def plain(x, w, bias, activation, tile_l):
        return convdk_conv1d.conv1d_plain(x, w, bias, activation)

    out = {"kernel": run(True)}
    with mock.patch.object(ops, "conv1d", plain):
        out["kernel_plain"] = run(True)
    out["model_plain"] = run(False)
    want = 2 * len(LM_CONVS) * cfg.n_layers
    rel = {k: [abs(a - b) / abs(b) for a, b in zip(out["kernel"][:2],
                                                   out[k][:2])]
           for k in ("kernel_plain", "model_plain")}
    good = (max(rel["kernel_plain"]) <= LM_BF16_ROUTE_RTOL
            and out["kernel"][2] == want and out["kernel_plain"][2] == 0)
    for k, v in out.items():
        print(f"  bf16 loss and gradients from the trained weights at "
              f"{LM_TRAIN_BATCH[0]} x {LM_TRAIN_BATCH[1]}, {k}: loss "
              f"{v[0]:.6f} grad norm {v[1]:.6f} ({v[2]} conv1d)"
              + (f"; against the kernel: rel diff {rel[k][0]:.3e} / "
                 f"{rel[k][1]:.3e}" if k in rel else ""))
    print(f"  the kernel against its plain version in the same route: tol "
          f"{LM_BF16_ROUTE_RTOL:g}, {want} launches "
          f"{'ok' if good else 'FAIL'}; the model's plain route not gated")
    return good, {**out, "rel": rel}


def _lm_resume(torch, cfg, tcfg):
    """A full-width LM_RESUME[0]-layer Trainer under deterministic
    algorithms: 2 steps, a checkpoint, a fresh Trainer restored from it to
    step 4, against 4 straight steps, bit for bit."""
    import dataclasses
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import Trainer
    from repro_torch.train.checkpoint import _leaf_names

    layers, b, seq = LM_RESUME
    small = dataclasses.replace(cfg, n_layers=layers)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=b)
    d = os.path.join(ROOT, "build", "chip_smoke", "lm_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        straight = Trainer(small, tcfg, dcfg, device=DEVICE)
        want = straight.run(4, ckpt_every=0, log_every=0)
        first = Trainer(small, tcfg, dcfg, device=DEVICE)
        got = first.run(2, ckpt_every=0, log_every=0)
        first.ckpt_dir = d
        t0 = time.perf_counter()
        first.save()
        save_s = time.perf_counter() - t0
        del first
        nbytes = sum(os.path.getsize(os.path.join(root, f))
                     for root, _, files in os.walk(d) for f in files)
        second = Trainer(small, tcfg, dcfg, ckpt_dir=d, device=DEVICE)
        t0 = time.perf_counter()
        restored = second.maybe_restore()
        _sync(torch)
        restore_s = time.perf_counter() - t0
        second.ckpt_dir = None                  # no save at its end
        got += second.run(4, ckpt_every=0, log_every=0)
    finally:
        torch.use_deterministic_algorithms(False)
    a = _leaf_names({"params": second.params, "opt": second.opt_state})
    w = _leaf_names({"params": straight.params, "opt": straight.opt_state})
    same = (restored and got == want and a.keys() == w.keys()
            and all(torch.equal(a[k], w[k]) for k in w))
    print(f"  resume at full width, {layers} layers, {b} x {seq}: checkpoint "
          f"at step 2, {nbytes} bytes, saved in {save_s:.2f} s, restored in "
          f"{restore_s:.2f} s; losses {got} against 4 straight {want}: "
          f"params and optimizer state "
          f"{'equal bit for bit, ok' if same else 'differ, FAIL'}")
    shutil.rmtree(d, ignore_errors=True)
    return same, {"checkpoint_bytes": nbytes, "save_s": save_s,
                  "restore_s": restore_s, "losses": got,
                  "bit_for_bit": same}


def dense_init(torch):
    """Full-width Gemma-2B, fp32 weights from a seeded generator on the
    card, materialized once for the dense phases; its parameter count
    against the definition's."""
    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.models.model import model_def
    from repro_torch.models.param import count_params, materialize

    t0 = time.perf_counter()
    tree = model_def(CONFIG)
    params = materialize(tree, _card_generator(torch, 0), DEVICE)
    _sync(torch)
    n = count_params(params)
    init_s = time.perf_counter() - t0
    print(f"  Gemma-2B ({CONFIG.n_layers} layers, d_model {CONFIG.d_model}, "
          f"{CONFIG.n_heads} query heads over {CONFIG.n_kv_heads} KV head, "
          f"head_dim {CONFIG.head_dim}, GeGLU {CONFIG.d_ff}, vocab "
          f"{CONFIG.vocab} tied): {n} parameters (the definition: "
          f"{count_params(tree)}), {4 * n / 1e9:.2f} GB fp32, materialized "
          f"in {init_s:.1f} s")
    return params, {"params": n, "init_s": init_s,
                    "count_ok": n == count_params(tree)}


def dense_model_phase(torch, params, info):
    """Full-width Gemma-2B: in fp32 at 1 x DENSE_TOKENS the forward through
    the chunked online softmax (S past q_chunk) against the same forward
    with dense scores, a 2-layer copy at DENSE_CPU against the CPU, then
    the bf16 prefill step at 1 x DENSE_TOKENS timed and traced; no kernel
    of B1-B7 launches on this path."""
    import dataclasses
    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.core.telemetry import measure
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.model import forward
    from repro_torch.train.step import make_prefill_step

    gen = torch.Generator().manual_seed(9)
    ok = info["count_ok"]
    f32 = dataclasses.replace(CONFIG, dtype="float32")
    shape = (1, DENSE_TOKENS, CONFIG.vocab)
    with torch.inference_mode():
        tokens = torch.randint(0, CONFIG.vocab, (1, DENSE_TOKENS),
                               generator=gen).to(DEVICE)
        reset_launches()                        # the main path starts here
        chunked = forward(params, {"tokens": tokens}, f32)
        _sync(torch)
        counts = launches()                     # ... and ends here
        dense = forward(params, {"tokens": tokens}, f32, use_chunked=False)
        rel = _rel(chunked, dense)
        good = (bool(torch.isfinite(chunked).all()) and rel <= MODEL_RTOL
                and tuple(chunked.shape) == shape
                and not any(counts.values()))
        print(f"  fp32 forward 1 x {DENSE_TOKENS} (q_chunk "
              f"{CONFIG.q_chunk}, kv_chunk {CONFIG.kv_chunk}): chunked "
              f"online softmax vs dense scores, max|dense| "
              f"{float(dense.abs().max()):.4e}, rel err {rel:.3e} (tol "
              f"{MODEL_RTOL:g}); launches {counts} (want none) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        del chunked, dense

        two = dataclasses.replace(f32, n_layers=2)
        p2 = _first_layers(params, 2)
        tokens = torch.randint(0, CONFIG.vocab, DENSE_CPU, generator=gen)
        got = forward(p2, {"tokens": tokens.to(DEVICE)}, two)
        ref = forward(_cpu_tree(torch, p2), {"tokens": tokens}, two)
        cpu_rel = _rel(got, ref)
        good = bool(torch.isfinite(got).all()) and cpu_rel <= MODEL_RTOL
        print(f"  2-layer full-width copy, {DENSE_CPU[0]} x {DENSE_CPU[1]}, "
              f"vs the CPU run: max|cpu| {float(ref.abs().max()):.4e} rel "
              f"err {cpu_rel:.3e} (tol {MODEL_RTOL:g}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        del got, ref, p2

        step = make_prefill_step(CONFIG)        # bf16
        batch = {"tokens": torch.randint(0, CONFIG.vocab, (1, DENSE_TOKENS),
                                         generator=gen).to(DEVICE)}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                        # the main path starts here
        nxt = step(params, batch)
        _sync(torch)
        step_counts = launches()                # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        good = (not any(step_counts.values()) and nxt.shape == (1,)
                and 0 <= int(nxt) < CONFIG.vocab)
        print(f"  bf16 prefill step 1 x {DENSE_TOKENS}: next token "
              f"{int(nxt)}, launches {step_counts} (want none), peak "
              f"{peak:.1f} GB {'ok' if good else 'FAIL'}")
        ok &= good
        fwd = measure(lambda: step(params, batch), iters=3, warmup=1)
    print(f"  bf16 prefill step (1 x {DENSE_TOKENS}): {fwd.mean_ms:.3f} ms "
          f"(CUDA events, mean of 3), {DENSE_TOKENS / fwd.mean_ms * 1e3:.0f} "
          f"tokens/s")
    trace = trace_phase(torch, lambda: step(params, batch), fwd.mean_ms)
    launched = sum(counts.values()) + sum(step_counts.values())
    return bool(ok), launched, dict(
        info, chunked_rel_err=rel, cpu_rel_err=cpu_rel,
        prefill_ms=fwd.mean_ms, prefill_tokens_per_s=DENSE_TOKENS
        / fwd.mean_ms * 1e3, peak_gb=peak, trace=trace)


def dense_serve_phase(torch, params):
    """The engine on full-width Gemma-2B in bf16 on LM_REQUESTS, then its
    fp32 decode-loop prefill against the forward."""
    from repro_torch.configs.gemma_2b import CONFIG

    ok, stats = _engine_phase(torch, CONFIG, params)
    good = not any(stats["launches"].values())
    print(f"  launches {stats['launches']} (want none) "
          f"{'ok' if good else 'FAIL'}")
    return ok and good, stats


# ---------------------------------------------------------------------------
# RecurrentGemma-9B: the hybrid family, B7 without an activation
# ---------------------------------------------------------------------------

def rg_kernel_phase(torch, tc, stats) -> bool:
    """The conv1d kernel at ``activation=None`` on RecurrentGemma-9B's
    temporal conv (batch 1 x RG_TOKENS, D 4096, k 4, bias) against its
    plain version (``_conv1d_checks``)."""
    from repro_torch.configs.recurrentgemma_9b import CONFIG

    k = CONFIG.d_conv
    return _conv1d_checks(torch, tc, stats, _Harness(torch, 7000), "rgemma",
                          1, RG_TOKENS, (("rec/conv", CONFIG.lru_width),), k,
                          None)


def rg_init(torch):
    """Full-width RecurrentGemma-9B, fp32 weights from a seeded generator
    on the card, materialized once for the rg phases; its parameter count
    against the definition's and RG_PARAMS."""
    from repro_torch.configs.recurrentgemma_9b import CONFIG
    from repro_torch.models.model import model_def
    from repro_torch.models.param import count_params, materialize

    t0 = time.perf_counter()
    tree = model_def(CONFIG)
    params = materialize(tree, _card_generator(torch, 0), DEVICE)
    _sync(torch)
    n = count_params(params)
    init_s = time.perf_counter() - t0
    kinds = CONFIG.layer_kinds()
    print(f"  RecurrentGemma-9B ({CONFIG.n_layers} layers: "
          f"{kinds.count('R')} RG-LRU, {kinds.count('A')} local attention "
          f"over {CONFIG.window} positions, as 12 (R, R, A) blocks and an "
          f"(R, R) remainder; d_model {CONFIG.d_model}, {CONFIG.n_heads} "
          f"query heads over {CONFIG.n_kv_heads} KV head of "
          f"{CONFIG.head_dim}, GeGLU {CONFIG.d_ff}, vocab {CONFIG.vocab} "
          f"tied): {n} parameters (the definition: {count_params(tree)}, "
          f"want {RG_PARAMS}), {4 * n / 1e9:.2f} GB fp32, materialized in "
          f"{init_s:.1f} s")
    return params, {"params": n, "init_s": init_s,
                    "count_ok": n == count_params(tree) == RG_PARAMS}


def _rg_block(params):
    """The first (R, R, A) block of a hybrid tree (views), no remainder."""
    return {k: (_first_layers(v, 1) if k == "stack" else v)
            for k, v in params.items() if k != "rem"}


def rg_model_phase(torch, params, info):
    """Full-width RecurrentGemma-9B: in fp32 at 1 x RG_TOKENS (past the
    window 2048 and q_chunk 2048) the kernel route against the plain
    route and the chunked online softmax against dense scores, with the
    launch counts of both routes; a 3-layer (R, R, A) copy at DENSE_CPU
    against the CPU; then the bf16 prefill step at 1 x RG_TOKENS timed and
    traced."""
    import dataclasses
    from repro_torch.configs.recurrentgemma_9b import CONFIG
    from repro_torch.core.telemetry import measure
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.model import forward
    from repro_torch.train.step import make_prefill_step

    per_forward = CONFIG.layer_kinds().count("R")
    gen = torch.Generator().manual_seed(13)
    ok = info["count_ok"]
    f32 = dataclasses.replace(CONFIG, dtype="float32")
    shape = (1, RG_TOKENS, CONFIG.vocab)

    def counted(kernel):
        counts = launches()
        want = per_forward if kernel else 0
        good = (counts["conv1d"] == want
                and not any(v for k, v in counts.items() if k != "conv1d"))
        return counts, want, good

    res = {}
    with torch.inference_mode():
        tokens = torch.randint(0, CONFIG.vocab, (1, RG_TOKENS),
                               generator=gen).to(DEVICE)
        out = {}
        for kernel in (True, False):
            cfg = dataclasses.replace(f32, use_convdk_kernel=kernel)
            reset_launches()                    # the main path starts here
            out[kernel] = forward(params, {"tokens": tokens}, cfg)
            _sync(torch)
            counts, want, good = counted(kernel)  # ... and ends here
            good &= tuple(out[kernel].shape) == shape
            print(f"  fp32 forward 1 x {RG_TOKENS}, kernel {kernel}: logits "
                  f"{tuple(out[kernel].shape)}, launches {counts} (want "
                  f"{want} conv1d) {'ok' if good else 'FAIL'}")
            ok &= good
            if kernel:
                res["fp32_launches"] = counts
        rel = _rel(out[True], out[False])
        good = bool(torch.isfinite(out[True]).all()) and rel <= MODEL_RTOL
        print(f"  kernel route vs plain route on the card: max|plain| "
              f"{float(out[False].abs().max()):.4e}, rel err {rel:.3e} (tol "
              f"{MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
        ok &= good
        res["kernel_vs_plain_rel_err"] = rel
        del out[False]
        dense = forward(params, {"tokens": tokens},
                        dataclasses.replace(f32, use_convdk_kernel=True),
                        use_chunked=False)
        rel = _rel(out[True], dense)
        good = bool(torch.isfinite(dense).all()) and rel <= MODEL_RTOL
        print(f"  chunked online softmax (q_chunk {CONFIG.q_chunk}, kv_chunk "
              f"{CONFIG.kv_chunk}) vs dense scores, window {CONFIG.window}: "
              f"rel err {rel:.3e} (tol {MODEL_RTOL:g}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        res["chunked_rel_err"] = rel
        del out, dense

        three = dataclasses.replace(f32, n_layers=3, use_convdk_kernel=True)
        p3 = _rg_block(params)
        tokens = torch.randint(0, CONFIG.vocab, DENSE_CPU, generator=gen)
        got = forward(p3, {"tokens": tokens.to(DEVICE)}, three)
        ref = forward(_cpu_tree(torch, p3), {"tokens": tokens}, three)
        rel = _rel(got, ref)
        good = bool(torch.isfinite(got).all()) and rel <= MODEL_RTOL
        print(f"  3-layer (R, R, A) full-width copy, {DENSE_CPU[0]} x "
              f"{DENSE_CPU[1]}, vs the CPU run: max|cpu| "
              f"{float(ref.abs().max()):.4e} rel err {rel:.3e} (tol "
              f"{MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
        ok &= good
        res["cpu_rel_err"] = rel
        del got, ref, p3

        step = make_prefill_step(dataclasses.replace(
            CONFIG, use_convdk_kernel=True))            # bf16
        batch = {"tokens": torch.randint(0, CONFIG.vocab, (1, RG_TOKENS),
                                         generator=gen).to(DEVICE)}
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                        # the main path starts here
        nxt = step(params, batch)
        _sync(torch)
        counts, want, good = counted(True)      # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        good &= nxt.shape == (1,) and 0 <= int(nxt) < CONFIG.vocab
        print(f"  bf16 prefill step 1 x {RG_TOKENS}: next token {int(nxt)}, "
              f"launches {counts} (want {want} conv1d), peak {peak:.1f} GB "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        fwd = measure(lambda: step(params, batch), iters=3, warmup=1)
    print(f"  bf16 prefill step (1 x {RG_TOKENS}): {fwd.mean_ms:.3f} ms "
          f"(CUDA events, mean of 3), {RG_TOKENS / fwd.mean_ms * 1e3:.0f} "
          f"tokens/s")
    trace = trace_phase(torch, lambda: step(params, batch), fwd.mean_ms)
    return bool(ok), counts, dict(
        info, **res, prefill_ms=fwd.mean_ms,
        prefill_tokens_per_s=RG_TOKENS / fwd.mean_ms * 1e3, peak_gb=peak,
        trace=trace)


def rg_serve_phase(torch, params):
    """The engine on full-width RecurrentGemma-9B in bf16 on RG_REQUESTS
    (its decode steps take the plain conv update, as in JAX: no launch),
    its fp32 decode-loop prefill against the forward; then in fp32 on the
    3-layer (R, R, A) copy with the window cut to RG_WRAP's, every decode
    step's logits over RG_WRAP's tokens (the ring cache wraps) against the
    forward's rows."""
    import dataclasses
    from repro_torch.configs.recurrentgemma_9b import CONFIG
    from repro_torch.models.model import decode_step, forward, \
        init_decode_state

    cfg = dataclasses.replace(CONFIG, use_convdk_kernel=True)
    ok, stats = _engine_phase(torch, cfg, params, RG_REQUESTS, RG_NEW_TOKENS)
    good = not any(stats["launches"].values())
    print(f"  launches {stats['launches']} (want none) "
          f"{'ok' if good else 'FAIL'}")
    ok &= good
    batch, n, window = RG_WRAP
    three = dataclasses.replace(cfg, dtype="float32", n_layers=3,
                                window=window)
    p3 = _rg_block(params)
    tokens = torch.randint(0, CONFIG.vocab, (batch, n),
                           generator=torch.Generator().manual_seed(14)
                           ).to(DEVICE)
    with torch.inference_mode():
        full = forward(p3, {"tokens": tokens}, three)
        state = init_decode_state(three, batch, n, torch.float32, DEVICE)
        ring = state["stack"]["2_A"].k.shape[2]
        rows = []
        for t in range(n):
            logits, state = decode_step(p3, state, {"tokens": tokens[:, t]},
                                        three)
            rows.append(logits)
        rel = _rel(torch.stack(rows, 1), full)
    good = (bool(torch.isfinite(full).all()) and rel <= MODEL_RTOL
            and ring == window)
    print(f"  fp32 decode loop over {batch} x {n} tokens on the 3-layer copy, "
          f"window cut to {window} (a ring of {ring} slots, rewritten from "
          f"token {ring} on), every row vs the forward: rel err {rel:.3e} "
          f"(tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
    return bool(ok and good), dict(stats, ring_wrap_rel_err=rel)


# ---------------------------------------------------------------------------
# the MoE family: Granite-MoE 3B-A800M, and DeepSeek-V2 with MLA
# ---------------------------------------------------------------------------

def _routed_verdict(torch, what, got, ref, got_log, ref_log):
    """The routing rule (phase 25): a MoE forward's logits ``got`` against
    ``ref`` (B, S, V), their runs' route records beside them."""
    from repro_torch.models.moe import route_flips

    n, first, gap = route_flips(got_log, ref_log)
    b, s = ref.shape[:2]
    if n == 0:
        rel = _rel(got, ref)
        good = bool(torch.isfinite(got).all()) and rel <= MODEL_RTOL
        print(f"  {what}: top-k choices equal in all {len(ref_log)} MoE "
              f"layers; max|ref| {float(ref.abs().max()):.4e} rel err "
              f"{rel:.3e} (tol {MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
    else:
        rows = got.reshape(b * s, -1)[:first]
        rel = _rel(rows, ref.reshape(b * s, -1)[:first]) if first else 0.0
        good = (gap <= NEAR_TIE and rel <= MODEL_RTOL
                and bool(torch.isfinite(got).all()))
        print(f"  {what}: top-k choices differ at {n} tokens (over "
              f"{len(ref_log)} MoE layers); the first at flat token {first},"
              f" gap {gap:.3e} (a near tie under {NEAR_TIE:g}); the {first} "
              f"tokens before it: rel err {rel:.3e} (tol {MODEL_RTOL:g}) "
              f"{'ok' if good else 'FAIL'}")
    return good, {"flips": n, "first_flip": first, "gap": gap,
                  "rel_err": rel}


def _drops(log):
    return [int(r.dropped) for r in log]


def _timed_prefill(torch, cfg, params, tokens, gen, what):
    """The bf16 prefill step at 1 x ``tokens``: launches (want none), its
    drops per MoE layer, peak memory, CUDA-event ms (mean of 3), trace."""
    from repro_torch.core.telemetry import measure
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.moe import recording
    from repro_torch.train.step import make_prefill_step

    step = make_prefill_step(cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, tokens),
                                     generator=gen).to(DEVICE)}
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                        # the main path starts here
        with recording() as log:
            nxt = step(params, batch)
            _sync(torch)
        counts = launches()                     # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        drops = _drops(log)
        good = (not any(counts.values()) and nxt.shape == (1,)
                and 0 <= int(nxt) < cfg.vocab)
        print(f"  bf16 prefill step 1 x {tokens}: next token {int(nxt)}, "
              f"launches {counts} (want none), peak {peak:.1f} GB; pairs "
              f"dropped per MoE layer {drops} (of {tokens * cfg.top_k} a "
              f"layer) {'ok' if good else 'FAIL'}")
        fwd = measure(lambda: step(params, batch), iters=3, warmup=1)
    print(f"  {what} bf16 prefill step (1 x {tokens}): {fwd.mean_ms:.3f} ms "
          f"(CUDA events, mean of 3), {tokens / fwd.mean_ms * 1e3:.0f} "
          f"tokens/s")
    trace = trace_phase(torch, lambda: step(params, batch), fwd.mean_ms)
    return good, counts, {"prefill_ms": fwd.mean_ms,
                          "prefill_tokens_per_s": tokens / fwd.mean_ms * 1e3,
                          "peak_gb": peak, "bf16_drops": drops,
                          "trace": trace}


def moe_init(torch):
    """Full-width Granite-MoE 3B-A800M, fp32 weights from a seeded
    generator on the card, materialized once for the MoE phases; its
    parameter count against the definition's and MOE_PARAMS."""
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG
    from repro_torch.models.model import model_def
    from repro_torch.models.param import count_params, materialize

    t0 = time.perf_counter()
    tree = model_def(CONFIG)
    params = materialize(tree, _card_generator(torch, 0), DEVICE)
    _sync(torch)
    n = count_params(params)
    init_s = time.perf_counter() - t0
    print(f"  Granite-MoE 3B-A800M ({CONFIG.n_layers} layers, d_model "
          f"{CONFIG.d_model}, {CONFIG.n_heads} query heads over "
          f"{CONFIG.n_kv_heads} KV heads of {CONFIG.head_dim}; "
          f"{CONFIG.n_experts} experts padded to {CONFIG.n_experts_pad}, "
          f"top-{CONFIG.top_k}, d_ff {CONFIG.d_ff_expert} an expert; vocab "
          f"{CONFIG.vocab} tied): {n} parameters (the definition: "
          f"{count_params(tree)}, want {MOE_PARAMS}), {4 * n / 1e9:.2f} GB "
          f"fp32, materialized in {init_s:.1f} s")
    return params, {"params": n, "init_s": init_s,
                    "count_ok": n == count_params(tree) == MOE_PARAMS}


def moe_model_phase(torch, params, info):
    """Full-width Granite-MoE: a 2-layer copy at LM_CPU against the CPU by
    the routing rule; the fp32 forward at 1 x MOE_TOKENS twice, bit for
    bit, with its drops per layer; the bf16 prefill timed and traced."""
    import dataclasses
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.model import forward
    from repro_torch.models.moe import recording

    gen = torch.Generator().manual_seed(16)
    ok = info["count_ok"]
    f32 = dataclasses.replace(CONFIG, dtype="float32")
    res = {}
    with torch.inference_mode():
        two = dataclasses.replace(f32, n_layers=2)
        p2 = _first_layers(params, 2)
        tokens = torch.randint(0, CONFIG.vocab, LM_CPU, generator=gen)
        with recording() as got_log:
            got = forward(p2, {"tokens": tokens.to(DEVICE)}, two)
        with recording() as ref_log:
            ref = forward(_cpu_tree(torch, p2), {"tokens": tokens}, two)
        good, res["cpu"] = _routed_verdict(
            torch, f"2-layer full-width copy, {LM_CPU[0]} x {LM_CPU[1]}, vs "
            f"the CPU run", got, ref, got_log, ref_log)
        ok &= good
        del got, ref, p2

        tokens = torch.randint(0, CONFIG.vocab, (1, MOE_TOKENS),
                               generator=gen).to(DEVICE)
        out, logs = [], []
        for _ in range(2):
            reset_launches()                    # the main path starts here
            with recording() as log:
                out.append(forward(params, {"tokens": tokens}, f32))
                _sync(torch)
            counts = launches()                 # ... and ends here
            logs.append(log)
        same = torch.equal(out[0], out[1]) and all(
            torch.equal(a.top_e, b.top_e) for a, b in zip(*logs))
        drops = _drops(logs[0])
        good = (same and bool(torch.isfinite(out[0]).all())
                and tuple(out[0].shape) == (1, MOE_TOKENS, CONFIG.vocab)
                and len(drops) == CONFIG.n_layers
                and not any(counts.values()))
        print(f"  fp32 forward 1 x {MOE_TOKENS}, all {CONFIG.n_layers} "
              f"layers, twice: logits {tuple(out[0].shape)} "
              f"{'equal bit for bit' if same else 'DIFFER'}, every layer's "
              f"choices {'equal' if same else 'compared'}; launches {counts}"
              f" (want none) {'ok' if good else 'FAIL'}")
        print(f"  pairs dropped at capacity_factor {CONFIG.capacity_factor} "
              f"(capacity {_moe_capacity(CONFIG, MOE_TOKENS)} an expert, "
              f"{MOE_TOKENS * CONFIG.top_k} pairs a layer), per layer: "
              f"{drops}")
        ok &= good
        res.update(fp32_bit_equal=same, fp32_drops=drops)
        del out, logs

    good, counts, prefill = _timed_prefill(torch, CONFIG, params, MOE_TOKENS,
                                           gen, "Granite-MoE")
    ok &= good
    return bool(ok), sum(counts.values()), dict(info, **res, **prefill)


def _moe_capacity(cfg, tokens):
    from repro_torch.models.moe import _capacity
    return _capacity(tokens, cfg.moe_cfg())


def moe_serve_phase(torch, params):
    """The engine on full-width Granite-MoE in bf16 on MOE_REQUESTS, then
    its fp32 decode-loop prefill against the forward, both at
    capacity_factor 8, where neither drops."""
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG

    ok, stats = _engine_phase(torch, CONFIG, params, MOE_REQUESTS,
                              MOE_NEW_TOKENS, check={"capacity_factor": 8.0})
    good = not any(stats["launches"].values())
    print(f"  decode {stats['decode_tokens_per_s']:.1f} tokens/s; launches "
          f"{stats['launches']} (want none) {'ok' if good else 'FAIL'}")
    return ok and good, stats


def mla_init(torch):
    """DeepSeek-V2 at full width and reduced depth (MLA_LAYERS of its 60
    layers), fp32 weights from a seeded generator on the card; its
    parameter count against the definition's and MLA_PARAMS."""
    import dataclasses
    from repro_torch.configs.deepseek_v2_236b import CONFIG
    from repro_torch.models.model import model_def
    from repro_torch.models.param import count_params, materialize

    cfg = dataclasses.replace(CONFIG, n_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    tree = model_def(cfg)
    params = materialize(tree, _card_generator(torch, 0), DEVICE)
    _sync(torch)
    n = count_params(params)
    init_s = time.perf_counter() - t0
    print(f"  DeepSeek-V2 236B at reduced depth: {cfg.n_layers} of "
          f"{CONFIG.n_layers} layers ({cfg.n_dense_prefix} dense-prefix, "
          f"{cfg.n_layers - cfg.n_dense_prefix} MoE of {cfg.n_experts} "
          f"routed experts at top-{cfg.top_k} and {cfg.n_shared_experts} "
          f"shared, d_ff {cfg.d_ff_expert} an expert); MLA at "
          f"{cfg.n_heads} heads, q_lora {cfg.q_lora}, kv_lora "
          f"{cfg.kv_lora}, d_nope {cfg.d_nope}, d_rope {cfg.d_rope}; d_model"
          f" {cfg.d_model}, vocab {cfg.vocab}: {n} parameters (the "
          f"definition: {count_params(tree)}, want {MLA_PARAMS}), "
          f"{4 * n / 1e9:.2f} GB fp32, materialized in {init_s:.1f} s")
    return params, {"params": n, "init_s": init_s, "layers": cfg.n_layers,
                    "count_ok": n == count_params(tree) == MLA_PARAMS}


def mla_model_phase(torch, params, info):
    """DeepSeek-V2 at reduced depth: in fp32 the model at LM_CPU against
    the CPU and, at 1 x MOE_TOKENS, chunked against dense MLA, both by the
    routing rule; the decode loop, absorbed and expanded, against the
    forward and each other; the bf16 prefill timed and traced."""
    import dataclasses
    from repro_torch.configs.deepseek_v2_236b import CONFIG
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models.model import (decode_step, forward,
                                          init_decode_state)
    from repro_torch.models.moe import recording

    gen = torch.Generator().manual_seed(18)
    ok = info["count_ok"]
    cfg = dataclasses.replace(CONFIG, n_layers=MLA_LAYERS)
    f32 = dataclasses.replace(cfg, dtype="float32")
    res = {}
    with torch.inference_mode():
        tokens = torch.randint(0, cfg.vocab, LM_CPU, generator=gen)
        with recording() as got_log:
            got = forward(params, {"tokens": tokens.to(DEVICE)}, f32)
        t0 = time.perf_counter()
        cpu = _cpu_tree(torch, params)
        with recording() as ref_log:
            ref = forward(cpu, {"tokens": tokens}, f32)
        del cpu
        good, res["cpu"] = _routed_verdict(
            torch, f"the model, {LM_CPU[0]} x {LM_CPU[1]}, vs the CPU run "
            f"({time.perf_counter() - t0:.1f} s with the copy)", got, ref,
            got_log, ref_log)
        ok &= good
        del got, ref

        tokens = torch.randint(0, cfg.vocab, (1, MOE_TOKENS),
                               generator=gen).to(DEVICE)
        reset_launches()                        # the main path starts here
        with recording() as chunked_log:
            chunked = forward(params, {"tokens": tokens}, f32)
            _sync(torch)
        counts = launches()                     # ... and ends here
        with recording() as dense_log:
            dense = forward(params, {"tokens": tokens}, f32,
                            use_chunked=False)
        good, res["chunked"] = _routed_verdict(
            torch, f"fp32 forward 1 x {MOE_TOKENS}, chunked MLA (q_chunk "
            f"{cfg.q_chunk}, kv_chunk {cfg.kv_chunk}) vs dense scores",
            chunked, dense, chunked_log, dense_log)
        good &= (not any(counts.values())
                 and tuple(chunked.shape) == (1, MOE_TOKENS, cfg.vocab))
        res["fp32_drops"] = _drops(chunked_log)
        print(f"  launches {counts} (want none); pairs dropped at "
              f"capacity_factor {cfg.capacity_factor} (capacity "
              f"{_moe_capacity(cfg, MOE_TOKENS)} an expert): "
              f"{res['fp32_drops']} {'ok' if good else 'FAIL'}")
        ok &= good
        del chunked, dense

        b, n = MLA_DECODE
        d8 = dataclasses.replace(f32, capacity_factor=8.0)
        tokens = torch.randint(0, cfg.vocab, (b, n), generator=gen
                               ).to(DEVICE)
        full = forward(params, {"tokens": tokens}, d8)
        rows = {}
        for absorb in (True, False):
            c = dataclasses.replace(d8, mla_absorb=absorb)
            state = init_decode_state(c, b, n, torch.float32, DEVICE)
            steps = []
            for t in range(n):
                logits, state = decode_step(params, state,
                                            {"tokens": tokens[:, t]}, c)
                steps.append(logits)
            rows[absorb] = torch.stack(steps, 1)
            rel = _rel(rows[absorb], full)
            good = bool(torch.isfinite(rows[absorb]).all()) \
                and rel <= MODEL_RTOL
            print(f"  fp32 decode loop over {b} x {n} tokens, "
                  f"{'absorbed' if absorb else 'expanded'}, vs the forward "
                  f"(capacity_factor 8): rel err {rel:.3e} (tol "
                  f"{MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
            ok &= good
            res[f"decode_{'absorbed' if absorb else 'expanded'}_rel_err"] \
                = rel
        rel = _rel(rows[True], rows[False])
        good = rel <= MODEL_RTOL
        print(f"  absorbed vs expanded decode: rel err {rel:.3e} (tol "
              f"{MODEL_RTOL:g}) {'ok' if good else 'FAIL'}")
        ok &= good
        res["absorbed_vs_expanded_rel_err"] = rel
        del full, rows

    good, counts, prefill = _timed_prefill(torch, cfg, params, MOE_TOKENS,
                                           gen, "DeepSeek-V2 (2 layers)")
    ok &= good
    return bool(ok), sum(counts.values()), dict(info, **res, **prefill)


def _granite_moe_layer(torch):
    """One full-width Granite-MoE layer's experts and router, seeded, and
    x at 1 x MOE_TOKENS in fp32, on the card."""
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG
    from repro_torch.models.moe import moe_def
    from repro_torch.models.param import materialize

    cfg = CONFIG.moe_cfg()
    gen = torch.Generator().manual_seed(17)
    params = materialize(moe_def(cfg), gen, DEVICE)
    x = torch.randn(1, MOE_TOKENS, cfg.d_model, generator=gen).to(DEVICE)
    return params, x, cfg


# ---------------------------------------------------------------------------
# mesh: the sharded wrappers and the network plan over torch.distributed
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_nets():
    """(name, config, def, apply, side, stem activation) of the networks
    the mesh phase runs, full width."""
    from repro_torch.models.mbconv import (
        EffNetConfig, EffNetV2Config, MobileNetV3Config,
        efficientnet_b0_apply, efficientnet_b0_def, efficientnet_v2_s_apply,
        efficientnet_v2_s_def, mobilenet_v3_apply, mobilenet_v3_def)
    return (("b0", EffNetConfig(), efficientnet_b0_def,
             efficientnet_b0_apply, RES, "silu"),
            ("v3", MobileNetV3Config(), mobilenet_v3_def,
             mobilenet_v3_apply, V3_RES, "hard_swish"),
            ("v2s", EffNetV2Config(), efficientnet_v2_s_def,
             efficientnet_v2_s_apply, V2S_RES, "silu"))


def _mesh_inputs(torch, def_fn, cfg, side, seed):
    from repro_torch.models.param import materialize
    params = materialize(def_fn(cfg), torch.Generator().manual_seed(seed),
                         DEVICE)
    images = torch.rand(BATCH, side, side, 3,
                        generator=torch.Generator().manual_seed(seed + 1))
    return params, images.to(DEVICE)


def _mnv2_blocks(torch):
    """The 17 MobileNet-V2 separable blocks at MNV2_RES, batch BATCH:
    (input, taps, pointwise weight, layer, c_out), seeded."""
    from repro_torch.core.workloads import MOBILENET_V2_SEPARABLE
    hx = _Harness(torch, 4000 + MNV2_RES)
    return [(hx.rand(BATCH, layer.h, layer.w, layer.c),
             hx.rand(layer.k, layer.k, layer.c, scale=1 / layer.k),
             hx.rand(layer.c, c_out, scale=layer.c ** -0.5), layer, c_out)
            for layer, c_out in MOBILENET_V2_SEPARABLE]


def _block_parity(torch, S, mesh, specs, params, images, plan, stem_act,
                  rtol=MESH_RTOL):
    """Every block of the chain on the mesh at the plan's schedule and
    layouts (and its storage type: the plan's bytes), fed the
    single-device activation its single-device twin takes, so no
    difference compounds through the chain: (worst max|err| over rtol x
    max|ref| and its block, every block's counted model-axis words and out
    layout as the plan prices them, the worst max|err| itself)."""
    from repro_torch.models.mbconv import apply_block, stem_conv
    act = {"silu": torch.nn.functional.silu,
           "hard_swish": torch.nn.functional.hardswish}[stem_act]
    dp = S.conv_mesh_shape(mesh)[0]
    eb = plan.dtype_bytes
    dt = torch.float32 if eb == 4 else torch.bfloat16
    x = act(stem_conv(images.to(dt), params["stem"].to(dt)))
    worst, words_ok, worst_abs = (0.0, -1), True, 0.0
    for i, (sp, bp) in enumerate(zip(specs, plan.blocks)):
        p = params[f"block{i}"]
        want = apply_block(x, sp, p)[0]
        mesh.reset_counts()
        y, layout = apply_block(S.shard_to_layout(x, mesh, bp.in_layout),
                                sp, p, schedule=bp.schedule, mesh=mesh,
                                in_layout=bp.in_layout)
        sch = bp.schedule
        words_ok &= (dp * mesh.model_wire_words()
                     == (sch.collective_bytes + sch.transition_bytes) // eb
                     and layout == bp.out_layout and y.dtype == dt)
        got = S.gather_global(y, mesh, layout, sp.c_out)
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, (err / (rtol * float(want.float().abs().max())),
                            i))
        worst_abs = max(worst_abs, err)
        x = want
    return worst, words_ok, worst_abs


def _rg_attn(torch):
    """One full-width RecurrentGemma-9B attention layer with
    ``seq_shard_attn`` (16 query heads over one KV head of 256, window
    2048), seeded weights and x at 1 x RG_TOKENS in fp32, on the card."""
    import dataclasses
    from repro_torch.configs.recurrentgemma_9b import CONFIG
    from repro_torch.models.attention import attn_def
    from repro_torch.models.param import materialize

    cfg = dataclasses.replace(CONFIG, seq_shard_attn=True).attn_cfg(
        CONFIG.window)
    gen = torch.Generator().manual_seed(15)
    params = materialize(attn_def(cfg), gen, DEVICE)
    x = torch.randn(1, RG_TOKENS, CONFIG.d_model, generator=gen).to(DEVICE)
    return params, x, cfg


def _mesh_rank(rank, shape, port, out_dir):
    """One of two ranks on the one card (gloo): every network forward and
    the 17 separable blocks on the mesh, each gathered; rank 0 saves the
    results, every rank its forward ms."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import convdk_sharded as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import separable_block
    from repro_torch.models.mbconv import network_plan

    mesh = make_mesh(shape, device=DEVICE, backend="gloo",
                     init_method=f"tcp://localhost:{port}", rank=rank,
                     world_size=2)
    dp = S.conv_mesh_shape(mesh)[0]
    res = {"nets": {}, "sep": [], "transports": None}
    try:
        with torch.inference_mode():
            for name, cfg, def_fn, apply, side, stem_act in _mesh_nets():
                params, images = _mesh_inputs(torch, def_fn, cfg, side, 10)
                specs = _net_specs(name, cfg)
                plan = network_plan(specs, BATCH, side, side,
                                    S.conv_mesh_shape(mesh))
                worst, words_ok, _ = _block_parity(
                    torch, S, mesh, specs, params, images, plan, stem_act)
                apply(params, images, cfg, mesh=mesh)       # warm
                mesh.reset_counts()
                _sync(torch)
                t0 = time.perf_counter()
                logits = apply(params, images, cfg, mesh=mesh)
                _sync(torch)
                ms = (time.perf_counter() - t0) * 1e3
                res["nets"][name] = dict(
                    logits=logits.cpu(), ms=ms,
                    wire_words=dp * mesh.model_wire_words(),
                    plan_words=plan.interconnect_words,
                    counts={k: (c.calls, c.elements)
                            for k, c in mesh.counts.items()},
                    stem=plan.stem_layout, worst_block=worst,
                    block_words_ok=words_ok,
                    layouts=[(p.in_layout, p.out_layout)
                             for p in plan.blocks])
                del params, images
            for x, w_dw, w_pw, layer, c_out in _mnv2_blocks(torch):
                mesh.reset_counts()
                out, layout = separable_block(
                    S.shard_to_layout(x, mesh), {"dw": w_dw, "pw": w_pw},
                    stride=layer.s, dw_act="relu6", act=None, mesh=mesh)
                words = dp * mesh.model_wire_words()
                res["sep"].append(dict(out=S.gather_global(
                    out, mesh, layout, c_out).cpu(), wire_words=words))
            if mesh.size("model") > 1:
                # the sequence-parallel route: this rank's 2048 query rows
                from repro_torch.models.attention import attention
                params, x, cfg = _rg_attn(torch)
                mesh.reset_counts()
                out = attention(params, x, cfg, mesh=mesh)
                res["seq_attn"] = dict(out=out.cpu(), counts={
                    k: (c.calls, c.elements) for k, c in mesh.counts.items()})
                del params, x, out
                # the expert-parallel MoE: this rank's 24 of 48 experts
                from repro_torch.models.moe import moe_apply
                params, x, cfg = _granite_moe_layer(torch)
                mesh.reset_counts()
                out = moe_apply(params, x, cfg, mesh=mesh)
                res["moe"] = dict(out=out.cpu(), counts={
                    k: (c.calls, c.elements) for k, c in mesh.counts.items()})
                del params, x, out
            t0 = time.perf_counter()
            res["bf16"] = _mesh_rank_bf16(torch, S, mesh)
            res["bf16_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["grad"] = {dt: _b0_step(torch, dt, mesh)
                       for dt in ("float32", "bfloat16")}
        res["forced_scatter"] = _mesh_forced_scatter(torch, S, mesh)
        res["grad_s"] = time.perf_counter() - t0
        res["transports"] = dict(mesh.transports)
        res["host_calls"] = dict(mesh.host_calls)
        res["rank_ms"] = {n: r["ms"] for n, r in res["nets"].items()}
        res["rank_ms"].update({f"grad {dt}": r[2]
                               for dt, r in res["grad"].items()})
        tag = "x".join(map(str, shape))
        torch.save(res["rank_ms"], os.path.join(out_dir,
                                                f"mesh_{tag}_{rank}_ms.pt"))
        if rank == 0:
            torch.save(res, os.path.join(out_dir, f"mesh_{tag}.pt"))
    finally:
        mesh.close()


def _mesh_rank_bf16(torch, S, mesh):
    """One rank's bf16 work at the mesh phase: B0 with ``dtype="bfloat16"``
    block by block on the plan at 2-byte words and its whole forward, and
    the 17 MobileNet-V2 separable blocks in bf16, each gathered."""
    import dataclasses
    from repro_torch.models.common import separable_block
    from repro_torch.models.mbconv import network_plan

    dp = S.conv_mesh_shape(mesh)[0]
    name, cfg, def_fn, apply, side, stem_act = _mesh_nets()[0]
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params, images = _mesh_inputs(torch, def_fn, cfg, side, 10)
    specs = _net_specs(name, cfg)
    plan = network_plan(specs, BATCH, side, side, S.conv_mesh_shape(mesh), 2)
    worst, words_ok, worst_abs = _block_parity(
        torch, S, mesh, specs, params, images, plan, stem_act, BF16_RTOL)
    mesh.reset_counts()
    logits = apply(params, images, cfg, mesh=mesh)
    _sync(torch)
    out = dict(logits=logits.cpu(), worst_block=worst,
               worst_block_abs=worst_abs, block_words_ok=words_ok,
               wire_words=dp * mesh.model_wire_words(),
               plan_words=plan.interconnect_words,
               counts={k: (c.calls, c.elements)
                       for k, c in mesh.counts.items()}, sep=[])
    del params, images
    for x, w_dw, w_pw, layer, c_out in _mnv2_blocks(torch):
        x, w_dw, w_pw = x.bfloat16(), w_dw.bfloat16(), w_pw.bfloat16()
        mesh.reset_counts()
        y, layout = separable_block(
            S.shard_to_layout(x, mesh), {"dw": w_dw, "pw": w_pw},
            stride=layer.s, dw_act="relu6", act=None, mesh=mesh)
        words = dp * mesh.model_wire_words()
        out["sep"].append(dict(
            out=S.gather_global(y, mesh, layout, c_out).cpu(),
            wire_words=words))
    return out


MESH_GRAD_SEED = 12                        # the mesh backward's labels


def _b0_step(torch, dtype, mesh=None):
    """Full-width B0 at RES, batch BATCH, in ``dtype``, from the mesh
    phase's seeded weights and images: the trainer's cross-entropy at
    seeded labels, forward and backward, on ``mesh`` (its gradients summed
    over the batch axes) or on the single card (``loss.backward()``).
    Returns (loss, {leaf: gradient on the host}, ms of the second of two
    steps, forward and backward)."""
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.launch.mesh import sum_batch_grads

    _, cfg, def_fn, apply, side, _ = _mesh_nets()[0]
    cfg = dataclasses.replace(cfg, dtype=dtype)
    params, images = _mesh_inputs(torch, def_fn, cfg, side, 10)
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=torch
                           .Generator().manual_seed(MESH_GRAD_SEED)
                           ).to(DEVICE)
    names = sorted(_flat_tree(params))
    for _ in range(2):
        tree = _fresh_leaves(params)
        flat = _flat_tree(tree)
        _sync(torch)
        t0 = time.perf_counter()
        logits = apply(tree, images, cfg, mesh=mesh)
        loss = F.cross_entropy(logits.float(), labels)
        if mesh is None:
            loss.backward()
            grads = [flat[n].grad for n in names]
        else:
            grads = sum_batch_grads(mesh, torch.autograd.grad(
                loss, [flat[n] for n in names]))
        _sync(torch)
        ms = (time.perf_counter() - t0) * 1e3
    return (float(loss.detach()), {n: g.cpu() for n, g in zip(names, grads)},
            ms)


def _mesh_forced_scatter(torch, S, mesh):
    """B0 block 1's shape at RES, batch BATCH, in bf16 (the SE FCs fp32)
    through the MBConv wrapper forced to the psum_scatter exit, which no
    bf16 plan at (1, 2) picks, against the unsharded op on the card: (the
    worst max|err| over 2e-2 x max|ref|, gloo's transport of the bf16
    reduce-scatter of CUDA tensors, the host calls this case made); None
    without a model axis (no scatter to make)."""
    if S.conv_mesh_shape(mesh)[1] == 1:
        return None
    from repro_torch.core.autotune import get_mbconv_schedule
    from repro_torch.kernels.convdk_mbconv import convdk_mbconv_fused
    from repro_torch.models.mbconv import (
        EffNetConfig, block_chain_rows, effnet_block_specs)

    i = 1
    specs = effnet_block_specs(EffNetConfig())
    sp = specs[i]
    h, w, c_in, c_mid, c_out, k, s = block_chain_rows(
        specs, -(-RES // 2), -(-RES // 2))[i][:7]
    hx = _Harness(torch, 5000)
    bf = torch.bfloat16
    x = hx.rand(BATCH, h, w, c_in).to(bf)
    w_exp = hx.rand(c_in, c_mid, scale=c_in ** -0.5).to(bf)
    w_dw = hx.rand(k, k, c_mid, scale=1 / k).to(bf)
    se = (hx.rand(c_mid, sp.c_se, scale=c_mid ** -0.5),
          hx.rand(sp.c_se, scale=0.1),
          hx.rand(sp.c_se, c_mid, scale=sp.c_se ** -0.5),
          hx.rand(c_mid, scale=0.1))
    w_proj = hx.rand(c_mid, c_out, scale=c_mid ** -0.5).to(bf)
    acts = dict(exp_act=sp.act, dw_act=sp.act, se_act=sp.se_act,
                gate_act=sp.gate_act)
    key = "reduce_scatter.bfloat16"
    before = mesh.host_calls.get(key, 0)
    with torch.inference_mode():
        sch = get_mbconv_schedule(
            BATCH, h, w, c_in, c_mid, c_out, k, s, se_ratio=sp.se_ratio,
            dtype_bytes=2, mesh_shape=S.conv_mesh_shape(mesh),
            collective="psum_scatter")
        y = S.convdk_mbconv_fused_sharded(
            S.shard_to_layout(x, mesh), w_exp, w_dw, *se, w_proj, mesh=mesh,
            stride=s, tile_h=sch.tile_h, tile_w=sch.tile_w, mode=sch.mode,
            collective="psum_scatter", retain_splits=sch.retain_splits,
            **acts)
        got = S.gather_global(y, mesh, "model_sharded", c_out)
        one = get_mbconv_schedule(BATCH, h, w, c_in, c_mid, c_out, k, s,
                                  se_ratio=sp.se_ratio, dtype_bytes=2)
        ref = convdk_mbconv_fused(
            x, w_exp, w_dw, *se, w_proj, stride=s, tile_h=one.tile_h,
            tile_w=one.tile_w, mode=one.mode,
            retain_splits=one.retain_splits, **acts)
    err = float((got.float() - ref.float()).abs().max())
    fine = (got.dtype == bf and got.shape == ref.shape
            and bool(torch.isfinite(got).all()))
    return dict(ratio=err / (BF16_RTOL * float(ref.float().abs().max())),
                err=err, fine=fine, transport=mesh.transports.get(key),
                host_calls=mesh.host_calls.get(key, 0) - before,
                shape=(BATCH, h, w, c_in, c_mid, c_out))


def _mesh_grad_verdict(torch, tag, res, refs, rank_ms, smi):
    """The mesh backward of one shape against the single card's: every
    leaf's gradient, fp32 and bf16, and the forced bf16 scatter."""
    ok = True
    for dt, bar in (("float32", MESH_RTOL), ("bfloat16", BF16_RTOL)):
        (got_loss, got, _), (loss, want, one_ms) = res["grad"][dt], refs[dt]
        tree = max(float(g.float().abs().max()) for g in want.values())
        good = set(got) == set(want)
        worst, own, max_err = (0.0, ""), (0.0, ""), 0.0
        for n, r in want.items():
            g, r = got[n].float(), r.float()
            err = (g - r).abs()
            good &= g.shape == r.shape and bool(torch.isfinite(g).all())
            scale = float(r.abs().max())
            worst = max(worst, (float((err / (bar * r.abs() + bar * tree))
                                      .max()), n))
            if scale > 0:
                own = max(own, (float((err / (bar * r.abs() + bar * scale))
                                      .max()), n))
            max_err = max(max_err, float(err.max()))
        good &= worst[0] <= 1.0
        ok &= good
        ms = " / ".join(f"{m['grad ' + dt]:.3f}" for m in rank_ms)
        print(f"    b0 {RES} b{BATCH} {dt} forward + backward, the trainer's "
              f"cross-entropy: loss {got_loss!r} (single card {loss!r}); "
              f"{len(want)} parameter gradients summed over the batch axes "
              f"vs the single card's loss.backward(): max|err| "
              f"{max_err:.3e}, worst {worst[0]:.3f} of the bar (rtol "
              f"{bar:g}, atol {bar:g} x max|grad| over the tree "
              f"{tree:.3e}; {worst[1]}); at each leaf's own scale "
              f"{own[0]:.3f} ({own[1]}; reported); forward + backward ms "
              f"per rank {ms} (single card {one_ms:.3f}; parity run, two "
              f"ranks on one card: {smi}) {'ok' if good else 'FAIL'}")
    fs = res["forced_scatter"]
    if fs is None:
        print(f"    forced bf16 psum_scatter: mesh {tag} has no model axis, "
              f"nothing to scatter")
        return ok
    carried = fs["transport"] == "native" or (
        fs["transport"] == "host" and fs["host_calls"] >= 1)
    good = fs["fine"] and fs["ratio"] <= 1.0 and carried
    how = {"native": "natively", "host": "through the host"}.get(
        fs["transport"], f"with no transport recorded ({fs['transport']})")
    print(f"    forced bf16 psum_scatter, the MBConv wrapper at B0 block 1's "
          f"shape {fs['shape']}: max|err| {fs['err']:.3e}, {fs['ratio']:.3f} "
          f"x its tol ({BF16_RTOL:g} x max|ref|) against the unsharded op; "
          f"gloo's bf16 reduce_scatter of CUDA tensors ran {how} "
          f"({fs['host_calls']} host calls counted) "
          f"{'ok' if good else 'FAIL'}")
    return ok and good


def _net_specs(name, cfg):
    from repro_torch.models.mbconv import (
        effnet_block_specs, effnet_v2_block_specs, mobilenet_v3_specs)
    return {"b0": effnet_block_specs, "v3": mobilenet_v3_specs,
            "v2s": effnet_v2_block_specs}[name](cfg)


def _one_rank_nccl(torch, tk):
    """B0 224 b8 through the sharded path on a one-rank NCCL mesh (1, 1):
    bit for bit the unsharded fused forward, with the same launches."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.mesh import make_mesh

    name, cfg, def_fn, apply, side, _ = _mesh_nets()[0]
    params, images = _mesh_inputs(torch, def_fn, cfg, side, 10)
    with torch.inference_mode():
        reset_launches()
        ref = apply(params, images, cfg)
        _sync(torch)
        want = launches()
        mesh = make_mesh((1, 1), device=DEVICE, init_method=f"tcp://"
                         f"localhost:{_free_port()}", rank=0, world_size=1)
        try:
            from repro_torch.core import telemetry
            telemetry.reset()
            reset_launches()
            got = apply(params, images, cfg, mesh=mesh)
            _sync(torch)
            counts = launches()
            dispatched = telemetry.get_telemetry().get(
                "sharded.dispatch.mbconv")
        finally:
            mesh.close()
    same = bool(torch.equal(got, ref))
    good = same and counts == want and dispatched == 16
    print(f"  one-rank NCCL mesh (1, 1), B0 {side} batch {BATCH}: "
          f"{int(dispatched)} blocks through the sharded wrapper; logits "
          f"{'equal' if same else 'DIFFER from'} the unsharded forward's "
          f"bit for bit; launches {counts} (unsharded {want}) "
          f"{'ok' if good else 'FAIL'}")
    return good


def _v2s_witness(torch, apply, params, images, cfg, fused, halves):
    """What V2-S's logits amount to at full width with seeded random
    weights: the card's fused forward at batch 8, its two batch-4 halves
    and its staged forward at batch 8, each against the plain PyTorch
    forward on the host's CPU.  All three miss it by percents of
    max|logit| alike, so the order of fp32 sums alone moves them; printed
    as the evidence for holding V2-S's logits block by block at (1, 2).
    Fails only on a non-finite result."""
    staged = apply(params, images, cfg, fused=False).cpu()
    host = apply(_cpu_tree(torch, params), images.cpu(), cfg)
    errs = {n: float((t - host).abs().max())
            for n, t in (("fused b8", fused), ("fused b4+b4", halves),
                         ("staged b8", staged))}
    good = all(bool(torch.isfinite(t).all()) for t in (staged, host))
    print(f"  V2-S {V2S_RES} b{BATCH} against the plain forward on the CPU "
          f"(max|logit| {float(host.abs().max())!r}): max|err| "
          + ", ".join(f"{n} {e!r}" for n, e in errs.items())
          + f"; the card's fused against its staged "
          f"{float((fused - staged).abs().max())!r} "
          f"{'ok' if good else 'FAIL'}")
    return good


def _mesh_bf16_verdict(torch, r, ref16, sep_refs16):
    """The bf16 cases of one mesh shape against the single card's bf16
    results at the bf16 bar: B0 block by block and its logits, its counted
    model-axis words against the plan's at 2-byte words, and the 17
    separable blocks (no model-axis words)."""
    ratio, block = r["worst_block"]
    scale = float(ref16.float().abs().max())
    err = float((r["logits"].float() - ref16.float()).abs().max())
    good = (r["logits"].dtype == torch.bfloat16
            and r["logits"].shape == ref16.shape
            and bool(torch.isfinite(r["logits"]).all())
            and ratio <= 1.0 and r["block_words_ok"]
            and err <= BF16_RTOL * scale
            and r["wire_words"] == r["plan_words"])
    print(f"    b0 bf16: every block on the single card's bf16 input: worst "
          f"max|err| {ratio:.3f} x its tol ({BF16_RTOL:g} x max|ref|, block "
          f"{block}), words and layouts "
          f"{'as planned' if r['block_words_ok'] else 'NOT planned'}; "
          f"logits vs the single card's bf16 max|err| {err:.3e} (tol "
          f"{BF16_RTOL * scale:.3e}); model-axis words {r['wire_words']} "
          f"(plan at 2-byte words {r['plan_words']}); collectives "
          f"{r['counts']} {'ok' if good else 'FAIL'}")
    errs, sep_ok = [], True
    for s, ref in zip(r["sep"], sep_refs16):
        err = float((s["out"].float() - ref.float()).abs().max())
        errs.append(err / (BF16_RTOL * float(ref.float().abs().max())))
        sep_ok &= (s["out"].dtype == torch.bfloat16
                   and s["out"].shape == ref.shape and errs[-1] <= 1.0
                   and s["wire_words"] == 0)
    print(f"    MobileNet-V2's {len(sep_refs16)} separable blocks in bf16: "
          f"worst max|err| {max(errs):.3f} x its tol, no model-axis words "
          f"{'ok' if sep_ok else 'FAIL'}")
    # reported, not gated: each case against the JAX suite's absolute bf16
    # bar (BF16_ATOL), beside the bar above, which scales with max|ref|
    sep_abs = max(float((s["out"].float() - ref.float()).abs().max())
                  for s, ref in zip(r["sep"], sep_refs16))
    cases = {"b0 blocks (worst)": r["worst_block_abs"], "b0 logits": err,
             "separable blocks (worst)": sep_abs}
    print("    against the absolute bf16 bar " + f"{BF16_ATOL:g}: " + "; ".join(
        f"{k} {v:.3e} {'within' if v <= BF16_ATOL else 'MISSES it'}"
        for k, v in cases.items()))
    return good and sep_ok


def mesh_phase(torch, tk, smi):
    """The one-rank NCCL mesh, then two gloo ranks on the card at each of
    MESH_SHAPES against the single-device fused results (parity runs),
    forward and backward; ``smi`` the card's name and power limit."""
    import dataclasses
    import torch.multiprocessing as mp
    from repro_torch.kernels.convdk_fused import convdk_fused_separable
    from repro_torch.core.autotune import get_fused_schedule

    ok = _one_rank_nccl(torch, tk)
    refs, halves, spread = {}, {}, {}
    half = BATCH // 2
    with torch.inference_mode():
        for name, cfg, def_fn, apply, side, _ in _mesh_nets():
            params, images = _mesh_inputs(torch, def_fn, cfg, side, 10)
            refs[name] = apply(params, images, cfg).cpu()
            # the single card against itself: two half batches, whose
            # solved tiles may differ, and so the order of the fp32 sums;
            # at (2, 1) each rank runs one such half
            halves[name] = torch.cat([apply(params, images[:half], cfg),
                                      apply(params, images[half:], cfg)]
                                     ).cpu()
            spread[name] = float((halves[name] - refs[name]).abs().max())
            if name == "v2s":
                ok &= _v2s_witness(torch, apply, params, images, cfg,
                                   refs[name], halves[name])
            del params, images
        sep_refs, sep_refs16 = [], []
        for x, w_dw, w_pw, layer, c_out in _mnv2_blocks(torch):
            for eb, refs_at in ((4, sep_refs), (2, sep_refs16)):
                sch = get_fused_schedule(BATCH, layer.h, layer.w, layer.c,
                                         c_out, layer.k, layer.s,
                                         dtype_bytes=eb)
                dt = torch.float32 if eb == 4 else torch.bfloat16
                refs_at.append(convdk_fused_separable(
                    x.to(dt), w_dw.to(dt), w_pw.to(dt), stride=layer.s,
                    tile_h=sch.tile_h, tile_w=sch.tile_w, dw_act="relu6",
                    act=None).cpu())
        # B0 in bf16 on the single card: the mesh's bf16 reference
        name, cfg, def_fn, apply, side, _ = _mesh_nets()[0]
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        params, images = _mesh_inputs(torch, def_fn, cfg16, side, 10)
        ref16 = apply(params, images, cfg16).cpu()
        del params, images
        _sync(torch)
    # the single card's B0 forward + backward: the mesh backward's reference
    grad_refs = {dt: _b0_step(torch, dt) for dt in ("float32", "bfloat16")}
    # RecurrentGemma's attention layer unsharded: the reference of the
    # sequence-parallel route
    from repro_torch.models.attention import attention
    from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE
    from repro_torch.models.moe import moe_apply
    with torch.inference_mode():
        params, x, cfg = _rg_attn(torch)
        seq_ref = attention(params, x, cfg).cpu()
        params, x, cfg = _granite_moe_layer(torch)
        moe_ref = moe_apply(params, x, cfg).cpu()
        del params, x
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    summary = {}
    for shape in MESH_SHAPES:
        tag = "x".join(map(str, shape))
        t0 = time.perf_counter()
        mp.start_processes(_mesh_rank, args=(shape, _free_port(), out_dir),
                           nprocs=2, start_method="spawn")
        res = torch.load(os.path.join(out_dir, f"mesh_{tag}.pt"),
                         weights_only=False)
        rank_ms = [torch.load(os.path.join(out_dir, f"mesh_{tag}_{r}_ms.pt"))
                   for r in range(2)]
        print(f"  mesh {tag}, 2 ranks on the one card over gloo "
              f"({time.perf_counter() - t0:.1f} s with the spawn, "
              f"{res['bf16_s']:.1f} s of it the bf16 cases on rank 0); "
              f"transports {res['transports']}, calls through the host "
              f"{res['host_calls']}")
        for name, r in res["nets"].items():
            ref = refs[name]
            scale = float(ref.abs().max())
            err = float((r["logits"] - ref).abs().max())
            ratio, block = r["worst_block"]
            # V2-S's logits at full width amplify the order of fp32 sums to
            # percents (the single card against itself: ``spread``), so at
            # (1, 2) its parity is held block by block; at (2, 1) each rank
            # runs the single card's batch-4 half, and its logits are held
            # to those halves.  B0's and V3's logits to the batch-8 forward
            half_err = float((r["logits"] - halves[name]).abs().max())
            half_scale = float(halves[name].abs().max())
            if shape[1] == 1:
                logits_ok = half_err <= MESH_RTOL * half_scale
                if name != "v2s":
                    logits_ok &= err <= MESH_RTOL * scale
            else:
                logits_ok = name == "v2s" or err <= MESH_RTOL * scale
            gated = shape[1] == 1 or name != "v2s"
            good = (r["logits"].shape == ref.shape
                    and bool(torch.isfinite(r["logits"]).all())
                    and logits_ok and ratio <= 1.0 and r["block_words_ok"]
                    and r["wire_words"] == r["plan_words"])
            ok &= good
            print(f"    {name}: stem {r['stem']}, block 0 "
                  f"{r['layouts'][0][0]}->{r['layouts'][0][1]}; every block "
                  f"on the single-device input: worst max|err| "
                  f"{ratio:.3f} x its tol (block {block}), words and layouts "
                  f"{'as planned' if r['block_words_ok'] else 'NOT planned'};"
                  f" logits vs single-device max|err| {err:.3e} (tol "
                  f"{MESH_RTOL * scale:.3e}"
                  f"{'' if name != 'v2s' or not gated else ', not gated'}"
                  f"; the single card's two half batches against its batch "
                  f"{BATCH}: {spread[name]:.3e}); vs those halves max|err| "
                  f"{half_err!r} (tol {MESH_RTOL * half_scale:.3e}"
                  f"{'' if shape[1] == 1 else ', not gated'}"
                  f"{', bit for bit' if half_err == 0 else ''}); "
                  f"model-axis words {r['wire_words']} "
                  f"(plan {r['plan_words']}); collectives {r['counts']}; "
                  f"forward ms per rank (parity run) "
                  f"{' / '.join(f'{m[name]:.3f}' for m in rank_ms)} "
                  f"{'ok' if good else 'FAIL'}")
        errs, good = [], True
        for r, ref in zip(res["sep"], sep_refs):
            err = float((r["out"] - ref).abs().max())
            errs.append(err)
            good &= (r["out"].shape == ref.shape
                     and err <= MESH_RTOL * float(ref.abs().max())
                     and r["wire_words"] == 0)
        ok &= good
        print(f"    MobileNet-V2's {len(sep_refs)} separable blocks: max|err| "
              f"{max(errs):.3e}, no model-axis words "
              f"{'ok' if good else 'FAIL'}")
        if "seq_attn" in res:
            r = res["seq_attn"]
            err = float((r["out"] - seq_ref).abs().max())
            tol = MESH_RTOL * float(seq_ref.abs().max())
            # the gathered (1, S, 16, 256) rows
            want = {"all_gather.model": (1, seq_ref.numel())}
            good = (r["out"].shape == seq_ref.shape and err <= tol
                    and r["counts"] == want)
            ok &= good
            summary.setdefault("seq_attn", {})[tag] = dict(
                max_abs_err=err, tol=tol, counts=r["counts"])
            print(f"    RecurrentGemma-9B attention, 1 x {RG_TOKENS} fp32, "
                  f"sequence-parallel ({RG_TOKENS // shape[1]} query rows a "
                  f"rank against the whole K/V) vs the unsharded layer: "
                  f"max|err| {err:.3e} (tol {tol:.3e}); collectives "
                  f"{r['counts']} (want {want}) {'ok' if good else 'FAIL'}")
        if "moe" in res:
            r = res["moe"]
            err = float((r["out"] - moe_ref).abs().max())
            tol = MESH_RTOL * float(moe_ref.abs().max())
            want = {"all_reduce.model": (1, moe_ref.numel())}
            good = (r["out"].shape == moe_ref.shape and err <= tol
                    and r["counts"] == want)
            ok &= good
            summary.setdefault("moe", {})[tag] = dict(
                max_abs_err=err, tol=tol, counts=r["counts"])
            print(f"    Granite-MoE layer, 1 x {MOE_TOKENS} fp32, "
                  f"expert-parallel ({GRANITE.n_experts_pad // shape[1]} of "
                  f"{GRANITE.n_experts_pad} experts a rank, capacity "
                  f"{_moe_capacity(GRANITE, MOE_TOKENS)}) vs the single "
                  f"card: max|err| {err:.3e} (tol {tol:.3e}); "
                  f"collectives {r['counts']} (want {want}) "
                  f"{'ok' if good else 'FAIL'}")
        ok &= _mesh_bf16_verdict(torch, res["bf16"], ref16, sep_refs16)
        print(f"    the backward ({res['grad_s']:.1f} s on rank 0):")
        ok &= _mesh_grad_verdict(torch, tag, res, grad_refs, rank_ms, smi)
        summary[tag] = {"transports": res["transports"],
                        "grad_s": res["grad_s"],
                        "grad_loss": {dt: r[0]
                                      for dt, r in res["grad"].items()},
                        "grad_rank_ms": [{dt: m["grad " + dt]
                                          for dt in res["grad"]}
                                         for m in rank_ms],
                        "forced_scatter": res["forced_scatter"],
                        "host_calls": res["host_calls"],
                        "bf16_s": res["bf16_s"],
                        "bf16_worst_block": res["bf16"]["worst_block"],
                        "rank_ms": rank_ms, "single_card_spread": spread,
                        "vs_halves": {n: float((r["logits"] - halves[n])
                                               .abs().max())
                                      for n, r in res["nets"].items()},
                        "worst_block": {n: r["worst_block"]
                                        for n, r in res["nets"].items()},
                        "words": {n: r["wire_words"]
                                  for n, r in res["nets"].items()}}
    return bool(ok), summary


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)

    t0 = _phase("build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    from repro_torch.kernels import _build
    from repro_torch.kernels import convdk_fusedmb as tf
    from repro_torch.kernels import convdk_mbconv as tk
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}  nvcc {nvcc}  "
          f"device {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import convdk_conv1d as tc
    from repro_torch.kernels import convdk_dw as td
    from repro_torch.kernels import convdk_fused as tfs
    from repro_torch.kernels import ops
    tb = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    _build.build(LIBRARIES)
    for dtype in (torch.float32, torch.bfloat16):
        tk._lib(dtype)
        tf._lib(dtype)
    tfs._lib()
    tc._lib()
    print(f"  kernels built and loaded in {time.perf_counter() - tb:.1f} s;"
          f" each nvcc, in parallel: " + ", ".join(
              f"{k} {v:.1f} s" for k, v in _build.BUILD_SECONDS.items()))
    if "conv1d" in _build.BUILD_SECONDS:
        print(f"  conv1d.cu compiled in {_build.BUILD_SECONDS['conv1d']:.1f} s")
    ptxas = ptxas_report()
    hmma, sass_ok = sass_mma_counts()

    phases, marks = {"build": sass_ok}, [("build", t0)]

    def phase(name, title):
        marks.append((name, _phase(title)))

    stats = KernelStats()
    phase("kernels", f"kernels: B0 batch {BATCH}, every block at "
                     f"{SERVE_RES}, timed at {RES}")
    phases["kernels"] = kernel_phase(torch, tk, tf, stats)
    both_modes = {"b0": stats.both_modes("b0", RES)}
    phase("model", "model: B0 on the card vs the CPU plain run")
    phases["model"], params, params_cpu, forward, fwd_ms = model_phase(
        torch, tk)
    phase("trace", "trace: device time of the B0 forward by kernel")
    trace = trace_phase(torch, forward, fwd_ms)
    phase("serve", f"serve: VisionEngine at {SERVE_RES}, the B0 main path")
    phases["serve"], b0_launches, pct = serve_phase(torch, tk, params,
                                                    params_cpu)
    del params, params_cpu, forward
    phase("v2s-kernels", f"v2s-kernels: V2-S batch {BATCH} at {V2S_RES}, "
                         "every block")
    from repro_torch.models.mbconv import (
        EffNetV2Config, MobileNetV3Config, effnet_v2_block_specs,
        mobilenet_v3_specs)
    phases["v2s-kernels"] = chain_kernel_phase(
        torch, tk, tf, stats, "v2s", effnet_v2_block_specs(EffNetV2Config()),
        V2S_RES, 1000 + V2S_RES, lambda on_path: on_path,
        ("fusedmb", "mbconv"))
    phase("v2s-model", "v2s-model: V2-S on the card (its main path) vs the "
                       "CPU plain run")
    phases["v2s-model"], v2s_launches, forward, v2s_ms = \
        v2s_model_phase(torch)
    phase("v2s-trace", "v2s-trace: device time of the V2-S forward by "
                       "kernel")
    v2s_trace = trace_phase(torch, forward, v2s_ms)
    del forward
    phase("v3-kernels", f"v3-kernels: MobileNet-V3-Large batch {BATCH} at "
                        f"{V3_RES}, every block")
    phases["v3-kernels"] = chain_kernel_phase(
        torch, tk, tf, stats, "v3", mobilenet_v3_specs(MobileNetV3Config()),
        V3_RES, 2000 + V3_RES, lambda on_path: True, ("mbconv",))
    both_modes["v3"] = stats.both_modes("v3", V3_RES)
    phase("v3-model", "v3-model: MobileNet-V3-Large on the card (its main "
                      "path) vs the CPU plain run")
    phases["v3-model"], v3_launches, forward, v3_ms = v3_model_phase(torch)
    phase("v3-trace", "v3-trace: device time of the V3 forward by kernel")
    v3_trace = trace_phase(torch, forward, v3_ms)
    del forward
    phase("bf16-model", "bf16-model: B0, V3 and V2-S forwards in bf16 "
                        "beside fp32")
    phases["bf16-model"], bf16 = bf16_model_phase(torch, {
        "b0": (fwd_ms, trace), "v3": (v3_ms, v3_trace),
        "v2s": (v2s_ms, v2s_trace)})
    phase("paper", "paper: ConvDK on the card; every B0, V3 and V2-S block "
                   "fused and staged; the forwards both ways; the CIM model")
    phases["paper"], paper, paper_dw = paper_phase(torch, stats)
    phase("bench", "bench: the per-block sweep as a BENCH artifact, its diff "
                   "against the baseline, the calibration, serve_report")
    phases["bench"], bench = bench_phase(torch, tk, paper)
    phase("sep-kernels", f"sep-kernels: MobileNet-V2 batch {BATCH} at "
                         f"{MNV2_RES}, every separable block, fp32 and "
                         "bf16; the trainer's blocks")
    phases["sep-kernels"], (mnv2_launches, mnv2_bf16_launches,
                            mnv2_staged_bf16_launches) = \
        sep_kernel_phase(torch, tfs, td, ops, stats)
    phase("grad", "grad: each op's gradients on the card vs its plain "
                  "version; B0's vs the CPU")
    phases["grad"], b0_train = grad_phase(torch)
    phase("train", f"train: the separable trainer on the card, "
                   f"{TRAIN_STEPS} fused steps twice then {STAGED_STEPS} "
                   f"staged, deterministic")
    phases["train"], train_launches, train = train_phase(torch)
    phase("lm-kernels", f"lm-kernels: the conv1d kernel on a Mamba-2 2.7B "
                        f"layer's convs, 1 x {LM_TOKENS} tokens")
    phases["lm-kernels"] = lm_kernel_phase(torch, tc, stats)
    phase("lm-model", "lm-model: full-width Mamba-2 2.7B prefill, kernel vs "
                      "plain path, vs the CPU, timed")
    lm_params = lm_init(torch)
    phases["lm-model"], lm_launches, lm = lm_model_phase(torch, lm_params)
    phase("lm-serve", "lm-serve: the LM engine at full width")
    phases["lm-serve"], lm_serve = lm_serve_phase(torch, lm_params)
    phase("lm-train", "lm-train: the LM training step at full width, "
                      "kernel vs plain route, Trainer.run, resume")
    phases["lm-train"], lm_train_launches, lm_train = lm_train_phase(
        torch, tc, stats, lm_params)
    del lm_params
    torch.cuda.empty_cache()
    phase("dense-model", f"dense-model: full-width Gemma-2B, chunked vs "
                         f"dense attention at 1 x {DENSE_TOKENS}, vs the "
                         f"CPU, the bf16 prefill timed")
    dense_params, dense_info = dense_init(torch)
    phases["dense-model"], dense_launches, dense = dense_model_phase(
        torch, dense_params, dense_info)
    phase("dense-serve", "dense-serve: the LM engine on full-width Gemma-2B")
    phases["dense-serve"], dense_serve = dense_serve_phase(torch,
                                                           dense_params)
    del dense_params
    torch.cuda.empty_cache()
    phase("rg-kernels", f"rg-kernels: the conv1d kernel without an "
                        f"activation on RecurrentGemma-9B's temporal conv, "
                        f"1 x {RG_TOKENS} tokens")
    phases["rg-kernels"] = rg_kernel_phase(torch, tc, stats)
    phase("rg-model", f"rg-model: full-width RecurrentGemma-9B, kernel vs "
                      f"plain route and chunked vs dense attention at 1 x "
                      f"{RG_TOKENS}, vs the CPU, the bf16 prefill timed")
    rg_params, rg_info = rg_init(torch)
    phases["rg-model"], rg_launches, rg = rg_model_phase(torch, rg_params,
                                                         rg_info)
    phase("rg-serve", "rg-serve: the LM engine on full-width "
                      "RecurrentGemma-9B; decode across a ring wrap")
    phases["rg-serve"], rg_serve = rg_serve_phase(torch, rg_params)
    del rg_params
    torch.cuda.empty_cache()
    phase("moe-model", f"moe-model: full-width Granite-MoE 3B-A800M, all 32 "
                       f"layers: a 2-layer copy vs the CPU, the fp32 forward "
                       f"at 1 x {MOE_TOKENS} twice, drops per layer, the "
                       f"bf16 prefill timed")
    moe_params, moe_info = moe_init(torch)
    phases["moe-model"], moe_launches, moe = moe_model_phase(
        torch, moe_params, moe_info)
    phase("moe-serve", "moe-serve: the LM engine on full-width Granite-MoE "
                       "3B-A800M")
    phases["moe-serve"], moe_serve = moe_serve_phase(torch, moe_params)
    del moe_params
    torch.cuda.empty_cache()
    phase("mla-model", f"mla-model: DeepSeek-V2 236B at full width, reduced "
                       f"to {MLA_LAYERS} of its 60 layers (the dense prefix "
                       f"and one MoE layer): vs the CPU, chunked vs dense "
                       f"MLA at 1 x {MOE_TOKENS}, decode vs prefill, "
                       f"absorbed vs expanded, the bf16 prefill timed")
    mla_params, mla_info = mla_init(torch)
    phases["mla-model"], mla_launches, mla = mla_model_phase(
        torch, mla_params, mla_info)
    del mla_params
    torch.cuda.empty_cache()
    phase("mesh", f"mesh: the sharded wrappers and the network plan over "
                  f"torch.distributed on the one card, meshes (1, 1) NCCL "
                  f"and {MESH_SHAPES} gloo (parity runs)")
    phases["mesh"], mesh = mesh_phase(torch, tk, smi)
    marks.append(("end", time.perf_counter()))
    past = {}
    for r in stats.rows:
        if "past_one_ulp" in r:
            key = f"{r['net']} {r['kernel']}"
            past[key] = past.get(key, 0) + r["past_one_ulp"]
    print(f"\nbf16 elements past 1 bf16 ulp of the plain fp32 sum (each "
          f"within the fp32 bar): {sum(past.values())} over "
          f"{sum('past_one_ulp' in r for r in stats.rows)} rows; {past}")
    print(f"\nphases {phases}; seconds " + " ".join(
        f"{a[0]} {b[1] - a[1]:.1f}" for a, b in zip(marks, marks[1:])))

    with open(os.path.join(out_dir, "kernels.json"), "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "ptxas": ptxas,
                   "build_seconds": _build.BUILD_SECONDS,
                   "hmma": hmma,
                   "cuda": torch.version.cuda, "forward_ms": fwd_ms,
                   "trace": trace, "v2s_forward_ms": v2s_ms,
                   "v2s_trace": v2s_trace, "serve_latency_s": pct,
                   "v2s_launches": v2s_launches,
                   "v3_launches": v3_launches, "v3_forward_ms": v3_ms,
                   "v3_trace": v3_trace,
                   "b0_forward_backward": b0_train,
                   "train": train, "train_launches": train_launches,
                   "mnv2_launches": mnv2_launches,
                   "mnv2_bf16_launches": mnv2_bf16_launches,
                   "mnv2_staged_bf16_launches": mnv2_staged_bf16_launches,
                   "lm": lm, "lm_launches": lm_launches,
                   "lm_serve": lm_serve, "lm_train": lm_train,
                   "dense": dense,
                   "dense_serve": dense_serve, "rgemma": rg,
                   "rgemma_launches": rg_launches, "rgemma_serve": rg_serve,
                   "moe": moe, "moe_serve": moe_serve, "mla": mla,
                   "both_modes": both_modes,
                   "bf16": bf16, "bf16_past_one_ulp": past,
                   "paper": paper, "bench": bench, "mesh": mesh,
                   "rows": stats.rows}, f,
                  indent=1)
    if not all(phases.values()):
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": stats.summary(
        {"b0": b0_launches, "v2s": v2s_launches, "v3": v3_launches,
         "train": train_launches, "mnv2": mnv2_launches,
         "mnv2_bf16": mnv2_bf16_launches,
         "mnv2_staged_bf16": mnv2_staged_bf16_launches,
         "lm": lm_launches, "lm_train": lm_train["launches"],
         "rgemma": rg_launches,
         "paper_staged_dw2d": paper_dw,
         "b0_bf16": bf16["b0"]["launches"],
         "v2s_bf16": bf16["v2s"]["launches"],
         "v3_bf16": bf16["v3"]["launches"]}),
        "lm_launches_per_prefill_forward": lm_launches,
        "lm_train_launches_per_step": lm_train_launches,
        "rgemma_launches_per_prefill_forward": rg_launches,
        "dense_launches": dense_launches, "moe_launches": moe_launches,
        "mla_launches": mla_launches}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
