#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which raises (and exits non-zero) on failure:

1. card   — needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s name
            and power limit.
2. build  — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
            into ``build/kernels/`` (cached by a hash of the sources), one
            ``nvcc`` per source, all started together.
3. slice  — serves GCN (d_hidden 256, 2 layers, the paper configuration) on
            ``reddit_like@paper`` (25,000 nodes, 602 features, 41 classes) in
            4 partitions stacked on the card, 1-bit deterministic halos, random
            weights from a seeded generator: ``full_sweep()``, three
            ``query()`` batches, a 64-node ``refresh()`` that must equal a fresh
            ``full_sweep()`` bit for bit, and one stochastic sweep. Kernel
            launch counts are zeroed just before the first sweep and read just
            after it; every kernel must have launched.
4. small  — the same engine on ``yelp_like@smoke`` on the card and on the CPU
            (the plain PyTorch versions, which the CPU tests hold to the JAX
            reference): logits agree at 32 bits, site-0 halos agree exactly
            at 1 bit.
5. kernels — each GCN kernel against its plain PyTorch version on the tensors
            the slice's sweep produced: quantize (bits 1/2/4/8, stochastic and
            deterministic; scale/zero in float32 and in bfloat16, the wire's
            type, which must equal the float32 ones cast by torch) bit-equal,
            dequantize bit-equal from either, SpMM bit-equal and
            the same bits on a second run (the split of hub rows into
            ``SEGMENT``-edge segments is fixed by the CSR). Then a shape
            sweep of quantize and dequantize against their plain versions,
            bit for bit: bits 1/2/4/8, stochastic and deterministic, d in
            ``SWEEP_D``, rows 1/7/1,000, contiguous, a view one element into
            its buffer (4-byte aligned h and u, 1-byte aligned payload) and
            constant rows. Times beside the bytes-or-operations bound: the
            Low-bit Module's as device time per launch from
            ``torch.profiler`` (the CUDA-event time of back-to-back wrapper
            calls beside it), the rest by CUDA events; for SpMM also
            ``torch.sparse.mm`` and the kernel under other plans (segments
            of 64 or 256 edges, units heaviest first).
            The GCN's tensors are freed after this phase.
6. lm     — serves granite-3-2b at its full published config (40 layers,
            2,533,531,648 parameters, float32 from a seeded generator, as the
            reference's ``serve_lm``) through the port's ``generate``: batch 8,
            prompt 2,016 + 32 new tokens, i.e. one prefill over 2,048 positions
            and 31 greedy decode steps. Cut from the ``prefill_32k`` /
            ``decode_32k`` shapes (seq 32,768, batch 32 / 128) to fit this
            script's time. The flash kernel's count is zeroed just before and
            must read 40 just after (one launch per prefill layer; decode
            attention is plain PyTorch and launches none). Prints prefill ms,
            decode tokens/s, peak memory, the first tokens and a profiled
            prefill and decode step split by kernel.
7. lm-small — every LM's reduced config (``LM_SMALL_ARCHS``: granite-3-2b,
            yi-34b with its untied unembedding, olmoe-1b-7b's MoE,
            deepseek-v2-236b's MLA + MoE with v narrower than q/k,
            gemma2-27b's softcaps and windowed ring caches) on the card and
            on the CPU from the same numpy weights: prefill logits within
            rtol/atol 1e-4, greedy tokens equal.
7b. lm-moe — olmoe-1b-7b at its full config (16 layers, 6,919,096,320
            parameters), deepseek-v2-236b (a dense layer and 2 MoE layers of
            its 1 + 59, 9,330,789,376 parameters) and gemma2-27b (2 of its 23
            local/global pairs, 3,444,650,496 parameters) at their published
            widths, float32 from a seeded generator, each served through
            ``generate`` as [lm] serves granite (batch 8, prompt 2,016 + 32
            new; gemma2 batch 2, prompt 6,112 + 32, longer than its 4,096
            window) and freed before the next (``LM_MOE_RUNS``; the depth
            cut is the reference's ``launch/cells.py::_reduce_depth``).
            Counts zeroed before the first ``generate`` and read after it:
            exactly 16 / 3 / 4 flash launches, no other kernel. Prints
            prefill ms, decode tokens/s, peak GB, dropped MoE assignments
            per layer at prefill and at decode (a third ``generate``, which
            counts them and must give the same tokens), a profiled prefill
            split into flash, the expert products, the rest of the MoE FFN
            and the rest, and a profiled decode step. The prefill once more
            with the kernel and once with the plain attention
            (``attention_bshd_ref``) in its place
            (``plain_attention_logits``): gemma2's and olmoe's
            last-position logits within 1e-4 x max(1, largest |logit|),
            which holds gemma2 to more than finite logits though its greedy
            tokens are all 0; olmoe's plain prefill takes the kernel
            prefill's routing (``carried_routes``: a rounding of the
            attention would reroute tokens), and the line gives how many of
            its own top-k assignments would differ. deepseek-v2's plain
            score blocks would not fit beside its weights
            (``PLAIN_SCORES_GB``): each of its prefill's flash calls is held
            to the plain version over 16 of its 128 heads instead
            (``head_slice_check``).
8. flash  — the flash kernel against its plain versions on the slice's own
            layer-0 q/k/v: ``flash_fwd`` over (8*32, 2048, 64) with KV heads
            repeated 4:1, in float32 and from bfloat16 inputs, the model's
            ``attention_bshd`` (GQA through strides), a ragged windowed
            case (Sq = Skv = 2,080, window 100), head widths 1, 75, 200 and
            256 (window 37), and d = 128 (yi-34b's head width) at
            (8*32, 2048). Then ``attention_bshd`` at the served models' layer
            shapes (``FLASH_LM_SHAPES``): gemma2-27b's local (window 4,096)
            and global layers with softcap 50 at (2, 6,144, 32 / 16 heads,
            128), once more at scale 1 where the cap bends the scores, and
            deepseek-v2's MLA (8, 2,048, 128 heads, q/k 192, v 128, v a
            column slice of kv), against ``attention_bshd_ref`` row by row.
            Tolerance on the attention (acc / l): 1e-4
            absolute in float32, 2e-2 from bfloat16 inputs. CUDA-event times
            beside the operations bound (3xTF32: three TF32 tensor-core
            products per multiply-add), the plain version and
            ``scaled_dot_product_attention`` or, under a softcap,
            ``flex_attention`` (compiled by Inductor; held to the plain
            version within 1e-3; timed here only, the port never calls
            either).
8b. flash-bwd — the flash backward kernels (``flash_bwd_dq``, then
            ``flash_bwd_dkdv``, ``attention_bshd_bwd``) at ``FLASH_BWD_SHAPES``:
            granite-3-2b's training call (4, 2,048, GQA 32:8, D 64), D 128,
            gemma2's capped local and global layers and deepseek-v2's MLA
            (D 192, Dv 128) from ``FLASH_LM_SHAPES``, and edges (rows that
            see no key through kv_len, a window of 5, Sq 333 / Skv 410, D
            256 under a cap at scale 1, D 75 / Dv 33; GQA groups of 1 and
            8, D 32, one query row, Skv under a key tile, kv_len inside a
            tile under a window, MLA at Sq 333), on the kernel forward's
            own output and lse: dq, dk and dv each within 1e-4 x the
            largest of ``attention_bshd_bwd_ref``'s (over a slice of heads
            where its scores pass ``PLAIN_SCORES_GB``), two calls bit-equal,
            dq 0 on rows that see no key; the pair's and each kernel's ms
            beside the bound (five products as 3xTF32; each kernel's own:
            dq three, dkdv four) and its share of it, the plain backward,
            and the backward of ``scaled_dot_product_attention`` (no cap)
            or ``flex_attention`` (capped) (``flash_bwd_phase``).
8c. lm-train — ``make_train_step`` at published widths, float32 from
            seed 0, Adam 1e-3 on ``token_stream`` through the ``Prefetcher``
            (``LM_TRAIN_RUNS``): granite-3-2b at full depth (40 layers, 4 x
            2,048; the slice's main path), olmoe-1b-7b cut to 4 of 16
            layers, gemma2-27b to 1 of 23 (local, global) pairs at 1 x
            5,120 (past the 4,096 window), deepseek-v2-236b to segment 0
            (its dense MLA layer). Step 1's loss and every gradient leaf
            with the kernels against the same step with
            ``attention_bshd_ref``'s autograd in their place (batch 1 where
            its scores would not fit; olmoe's routing carried across) within
            1e-5 and 1e-3 x each leaf's largest; a small SGD step along that
            gradient lowers the loss by at least half the first-order
            prediction; launches exact in each of 1 + 5 steps (flash_fwd
            twice per layer, each backward kernel once, nothing else);
            finite losses (printed; six steps of fresh batches are too few
            to gate a falling loss, ``LM_TRAIN_DESCENT``); deepseek-v2's MLA
            call forward and backward over 16 heads. Step ms (host clock
            ending in ``float(loss)``, median of 5), tokens/s, peak GB and
            one profiled step split into flash forward, flash backward,
            cuBLAS and the rest (``lm_train_phase``; alone: ``python3
            tools/torch_lm_phase.py train``, ``flash-bwd`` the phase above).
9. summary — a ``{"kernels": [...]}`` line (each kernel's launches on
            every path: a serving sweep, each kind of training step, the
            zoo's steps, each LM's ``generate`` and training step, DLRM's
            steps, serving and retrieval; DLRM's SpMM call beside
            ``spmm_csr``'s times; the
            zoo's seg kernels and the flash backward with their times), the
            card line, and the last line ``{"ok": true,
            "device": {...}}``.

After phase 8c (``lm-train``) the zoo trains (``zoo_phase``):

zoo       — PNA 4x75 on ``reddit_like@paper``, MeshGraphNet 15x128 (MLPs of
            2 layers, 4 edge inputs) on ``mesh_like@paper`` (9,216 nodes),
            SchNet 3x64 (300 RBF, cutoff 10) and NequIP 5 x 32 (l <= 2, 8
            RBF, cutoff 5) on ``molecule_like@paper`` (400 nodes), the
            registry's full configs, through
            ``launch.train.gnn_graph`` (edge geometry on the host) and
            ``GNNTrainer``, P = 4, seed 0, ``ZOO_EPOCHS`` epochs each of
            vanilla, Sylvie-S (``Uniform(1)``) and Sylvie-A
            (``BoundedStaleness(eps_s=4)``, 1 bit), Adam at the rates of
            ``ZOO_ARCHS``. Counts zeroed before each epoch and read after
            it: exactly ``ZOO_LAUNCHES`` and no other kernel. Vanilla losses
            fall, 1-bit losses are finite (whether they fall is printed).
            Median epoch ms, peak GB, ``_gnn_model_flops`` per epoch; one
            Sylvie-A sync and async epoch of each profiled by kernel group
            (NequIP's ``tensor_product`` inside a ``nequip_tp`` range, its
            forward and backward device ms apart). NequIP on
            ``yelp_like@paper`` (20,000 nodes, 419,018 edges; ``ZOO_WIDE``):
            one warm Sylvie-A sync epoch, its 15 SpMM calls (over
            ``ecsr``, ``ecsr_t``, the scatter CSR) and 10 quantize calls at
            d = 288 recorded and each bit-equal to its plain version on
            the card and the same bits twice, dequantize of each result
            too (``zoo_wide_kernels``); one profiled epoch, exact
            launches, finite losses, peak GB (``zoo_wide``).
            ``seg_max_min`` and ``seg_max_min_bwd`` on one PNA Sylvie-S
            step's own tensors (4 calls each): bit-equal to their plain
            versions on the card, ties included, the same bits twice, also
            over ``SEG_ROW_LENGTHS`` x ``SEG_WIDTHS`` (±0 ties, a NaN,
            padded rows); timed beside their bytes bounds, the plain
            versions and, for the forward, ``scatter_reduce`` (amax +
            amin). The reduced configs' 32-bit
            logits on the smoke graphs, card against the CPU
            (``ZOO_PARITY_ATOL``), and a TF32 control that must fail that
            gate (``zoo_parity``). ``python3 tools/torch_zoo_phase.py`` runs
            this phase alone (``parity``: only ``zoo_parity``).

Then DLRM at the MLPerf widths (``dlrm_phase``; the counts zeroed before
each path and read after it, exactly ``DLRM_LAUNCHES``):

dlrm      — dlrm-mlperf (13 dense features, 26 tables of width 128, bottom
            MLP 13-512-256-128, dot interaction, top MLP
            1024-1024-512-256-1), every table capped at ``DLRM_ROWS`` = 2^22
            rows (25,035,512 rows, 12.82 GB; the published 187,767,399 rows
            would take 96 GB), float32 from seeded generators: (a) a batch's
            id plan (the transposed id CSR) on the host, its ms; (b) step
            1's gradient at batch 65,536 (1 ``spmm_csr``), an SGD step along
            it lowering the loss by half the first-order prediction
            (``DLRM_DESCENT``), and its SpMM call (the table's gradient over
            ~6,500 touched rows, row 0 of each table read by ~64.6% of the
            batch) recorded, bit-equal to the plain version and to itself,
            timed beside its bytes bound, ``torch.sparse.mm`` and
            ``index_add_``; (c) ``DLRM_STEPS`` Adam 1e-3 steps through
            ``launch.train.train_dlrm`` (``criteo_stream``, the
            ``Prefetcher`` building each id plan): the curve, finite losses,
            exact launches every step, step ms (host clock ending in
            ``float(loss)``, median of steps 6..20), samples/s, peak GB;
            (d) one profiled step split into cuBLAS, the table's gather,
            its gradient (the SpMM and the rest), the table's dense Adam
            and the rest, with the device's busy share; (e)
            ``make_serve_step`` at batch 512 and 262,144 (median of 5, CTR
            in [0, 1]); (f) ``make_retrieval_step``, one query against
            1,000,000 distinct field-0 candidates, top 64, equal to a full
            sort of the same scores; (g) the reduced config and the
            published widths with 26 tables of 64 rows on card and CPU:
            logits and two Adam steps' losses within ``ZOO_PARITY_ATOL``, a
            TF32 control outside it (``dlrm_parity``).

After [sharded-serve], [dlrm-sharded] (``dlrm_sharded_phase``): four
``gloo`` ranks on ``cuda:0`` (spawned as [sharded] spawns them), tables
capped at ``DLRM_SHARDED_ROWS`` = 2^20 rows, each rank's slice drawn from
its own seeded generator, a global batch of 16,384, 3 Adam steps at 32,
16 and 1 bits of the embedding exchange. At 32 bits against one process on
the concatenated slices: losses rtol 1e-5, step 1's table gradient on each
rank's rows within 1e-5 of the largest, the touched rows after the steps
within 2 x lr a step (the elements within rtol 1e-5 counted). Launches
exact on every rank (1 quantize and 1 dequantize a 1-bit step); at 1 bit
the last step's quantize and dequantize calls bit-equal to their plain
versions on the card; each collective's bytes and ms and each rank's step
ms. ``python3 tools/torch_dlrm_phase.py [single] [sharded]`` runs the two
alone.

After [dlrm], [sampled] (``sampled_phase``): the ``minibatch_lg`` cell. A
Reddit-sized stand-in (``SAMPLED_GRAPH``: ``powerlaw_community`` at
reddit_like's 232,965 nodes, average degree 492, 602 features, 41 classes,
seed 0; host seconds and peak RSS printed) and its ``NeighborSampler``;
GraphSAGE 256x2 (``SAGE_SPEC``) on ``Runtime.simulated(4)``, Adam 1e-2,
``SAMPLED_BATCHES`` batches of 1,024 seeds at fan-outs (15, 10) each of
vanilla and Sylvie-S (1 bit, stochastic), through ``sampled_train``: the
reference's Table-1 loop, the ``Prefetcher``'s worker doing the host half
(sample, self-loops, partition, block). Every count zeroed before each run
and read after it; gates: each subgraph within ``SamplerShapes``' bounds,
every step's launches ``TRAIN_LAUNCHES[("graphsage", run, "sync")]``, one
recorded Sylvie-S step's SpMM and Low-bit Module calls bit-equal to the
plain versions (``recorded_kernels``), the first vanilla loss within
``SAMPLED_PARITY_RTOL`` of the CPU's plain versions, finite losses,
vanilla's last five below ``SAMPLED_DESCENT`` x its first. It reports the
host ms a batch (sample, partition, block), the main thread's wait on the
queue, the step's host and device ms, one profiled step's busy share, peak
GB, the sampled sizes and the step's useful FLOPs over its device time.
Then [cells] (``cells_phase``): the 40 cells of ``launch.cells`` built at
4 devices, one line each; the card's allocated memory unchanged. Inside
[sharded]'s spawn, (g) (``sharded_zoo_rank``, gated by
``sharded_zoo_check``): PNA, MeshGraphNet, SchNet and NequIP at their full
configs on ``ZOO_ARCHS``' graphs, ``ZOO_SHARDED_EPOCHS`` epochs of vanilla
and Sylvie-A (1 bit, deterministic) with SGD at ``ZOO_ARCHS``' rate
(MeshGraphNet with Adam: ``ZOO_SHARDED_ADAM``, gated on losses and bytes),
trained by rank 0 on ``Runtime.simulated(4)`` first: losses rtol 1e-5 and
parameters within 1e-5 at 32 bits, ``SHARDED_ONE_BIT_RTOL`` and at most
``SHARDED_ROWS_APART`` halo rows apart at 1 bit, bytes equal, launches per
epoch ``zoo_step_launches`` on every rank, epoch ms per rank.
``python3 tools/torch_sampled_phase.py [sampled] [cells] [zoo]`` runs the
three alone.

Then the serving front runs (``serve_front_phase``), last, so that its host
work (checkpoints written and restored, the store's host tables) cannot
shift the host-clock times of the phases before it; every count is zeroed
just before each ``serve_once`` and read just after it:

serve-front — ``python -m repro_torch.launch.serve``'s ``serve_once`` on the
            card: (1) GCN 256x2 on ``reddit_like@paper`` (P=4, 1 bit),
            trained 3 epochs into a temporary checkpoint, then a closed loop
            of 8 clients x 400 requests x 16 ids with a 64-node delta
            refresh every 50 completions; every sweep launches exactly
            ``SERVE_LAUNCHES``, the 3 epochs 3 x ``TRAIN_LAUNCHES``' Sylvie-S
            step, all 400 requests complete, the measured delta ships fewer
            bytes than ``full_sweep_wire_bytes()`` and equals a full sweep
            bit for bit. (2) GraphSAGE and GAT the same way (100 requests),
            each sweep pinned by ``SERVE_LAUNCHES``, delta == full bit for
            bit. (3) ``gdelt_like@paper`` through the store (4,096 kB hot-node
            cache) and 2 replicas: a closed loop of 1,000 requests measures
            QPS, then an open loop offers half of it with Zipf skew 1.1 and
            60 mutation-stream events in 50 ms windows (both from the same
            checkpoint and settings): completed + lost = 1,000, ``verify_store()`` passes,
            the store's hits + misses equal the rows looked up; prints hit
            rate, miss bytes, refresh lag p50/p99, escalations and
            ``slo_pass`` at 50 ms (a speed: printed, not gated), and
            profiles one store-backed delta refresh. (4) Degraded mode on
            (1)'s engine: partition 1 down, a delta refresh leaves its
            logits bit for bit, its staleness 1; after ``set_up`` and a full
            sweep the logits equal a fresh engine's bit for bit. In every
            ``serve_once`` run the load generator's refreshes all ran (8 in
            (1), one per stream batch in (3)), none failed and the server
            stayed healthy; (3)'s lag p50/p99 come from the loop's own clock
            reads, checked against its reported max and mean. (5) (1)
            again, restored (not trained), untraced and then under
            ``obs.enable()``, and 3 epochs of GCN Sylvie-A untraced and
            traced: the same launches, logits and losses bit for bit; the span tree is ``epoch > decide > step``
            and ``request > lookup``, ``admit``, ``refresh > plan > sweep``;
            ``wall_s >= seconds``; the trace and metrics JSON go to
            ``artifacts/torch/obs/chip_smoke/``, span counts and median host
            ms are printed.

chaos     — after serve-front (last: it spawns processes and writes
            checkpoints); every count is zeroed before each epoch and read
            after it. (a) GCN 256x2 and GAT 4x64 on ``reddit_like@paper``,
            P=4, Sylvie-S (``Uniform(1)``) and Sylvie-A
            (``BoundedStaleness(4, 1)``), ``CHAOS_EPOCHS`` epochs under the
            ``chaos_smoke`` fault spec (``CHAOS_FAULT``), in turns with the
            same runs fault-free: every epoch ``faults_injected == halos_reused +
            forced_syncs`` and equal to what the host plan draws, some
            fault injected, losses finite, launches per step as
            ``TRAIN_LAUNCHES`` (a forced recovery epoch runs at 32 bits:
            vanilla's); the median epoch ms faulted and clean side by
            side, and the median of their paired ratios.
            (b) GCN Sylvie-S under a rate-zero plan: parameters bit-equal to
            no plan's after 3 epochs. (c) GCN and GAT, sync and async
            (``Uniform(1)``), 3 epochs under each exchange schedule:
            parameters and losses bit-equal, launches equal epoch by epoch;
            one more async epoch of each profiled: device-busy ms and the ms
            in which side-stream and main-stream kernels ran at once
            (``stream_profile``, from the trace's stream ids; printed, not
            gated). (d) ``python -m repro_torch.launch.chaos --kill-resume
            --dataset reddit_like@paper --epochs 4``: ``"bit_exact": true``,
            its second and third legs plan-cache hits. (e)
            ``run_scenario("chaos_smoke")`` on the card, the accounting on
            every cell; one ``smoke`` cell traced: the full report key set
            and its trace file.

sharded   — last, after chaos (``sharded_phase``): the multi-process runtime,
            four ranks spawned by ``repro_torch.dist.spawn`` on ``cuda:0``
            over ``gloo`` (by design: NCCL refuses two ranks on one device,
            so the NCCL path, a card per rank, is not run here), each
            training its own partition through ``Runtime.sharded(4,
            device="cuda:0")``; every count is zeroed before each epoch and
            read after it, in each rank. (a) Every exchange on
            ``reddit_like@paper``'s ring buckets and dense blocks (uint8,
            bfloat16, float32; compact forward and reversed) equals each
            rank's row of ``SimulatedBackend`` on the stacked CUDA tensor
            bit for bit. (b) GCN 256x2 vanilla, Sylvie-S and Sylvie-A,
            ``SHARDED_EPOCHS`` deterministic epochs with SGD, against
            ``Runtime.simulated(4)`` trained on the card by rank 0 first:
            losses rtol 1e-5 at 32 bits, ``SHARDED_ONE_BIT_RTOL`` at 1 bit;
            bytes per epoch equal; the gathered halo caches' rows apart
            counted (0 at 32 bits, at most ``SHARDED_ROWS_APART`` of them at
            1 bit); launches per step as ``TRAIN_LAUNCHES`` on every rank.
            GCN vanilla again with the trainer's default Adam: losses rtol
            1e-5, bytes and launches as above, its halo rows apart and the
            first step's parameter gap per leaf (beside SGD's) recorded.
            (c) GAT 4x64 Sylvie-A, deterministic, a sync and an async epoch
            with SGD, held to the simulated runtime by (b)'s gates.
            launches exact. (d) 3 epochs under ``CHAOS_FAULT``: the
            accounting identity, equal to the plan's draws on every rank;
            GCN sync and async under the overlap schedule bit-equal to
            blocking with equal launches. (e) Each rank's median epoch ms
            and each collective's bytes and ms, labelled host-staged
            ``gloo`` with the card line: no gain or wire speed is claimed.
            (f) The sharded census contracts of ``repro_torch.analysis``
            (``contracts.run_sharded``) on every rank: 0 findings.
            A rank's failed check fails ``spawn`` and the script.

sharded-serve — last, after sharded (``sharded_serve_phase``): serving under
            ``Runtime.sharded(4, device="cuda:0")``, four ``gloo`` ranks on
            the card, each sweeping its partition of ``reddit_like@paper``
            with weights from the seed, deterministic rounding; every rank
            calls the engine's ``lead``, rank 0 runs the front and the
            others follow its commands. (a) GCN 256x2 and (b) GraphSAGE
            256x2 and GAT 4x64, at 32 bits and at 1 bit: a full sweep, a
            64-node delta and a fresh full sweep, each equal bit for bit to
            the same front run by rank 0 on ``Runtime.simulated(4)`` first
            (logits rows apart counted; 0 expected: serving has no
            all-reduce); the delta equals the fresh full sweep; equal wire
            bytes and ``affected_rows``. (c) On every rank, one full sweep's
            and one delta's launches equal ``SERVE_LAUNCHES`` at 1 bit
            (counts zeroed before and read after each ``lead``). (d)
            Partition 2 down, then a delta: frozen rows and
            ``part_staleness`` equal the simulated engine's. (e) The front
            on rank 0: an ``EmbeddingServer`` over the engine with its store,
            a closed loop of ``SERVE_SHARDED_CLIENTS`` clients x
            ``SERVE_SHARDED_REQUESTS`` requests x ``SERVE_SHARDED_BATCH``
            ids with a 64-node delta every ``SERVE_SHARDED_EVERY``
            completions, traced (spans ``refresh``, ``plan``, ``sweep``,
            ``gather``: count and median host ms), every refresh run and
            none failed, ``verify_store()``; the publish of a delta's rows
            timed on rank 0; one full sweep profiled on each rank in turn
            while the others sweep too (device busy ms and its memcpy
            part, ``torch.profiler``). QPS, p50/p99 and every
            time are labelled host-staged ``gloo`` with the card line.

Between phases 5 and 6 (``lm``) four training phases run:

train     — GCN 256x2, GraphSAGE 256x2 and GAT (4 heads x 64, 2 layers),
            the paper configs of the port's registry, trained full-graph on
            ``reddit_like@paper``, P=4, at full width, ``TRAIN_EPOCHS``
            epochs each of vanilla (32 bits), Sylvie-S (``Uniform(1)``,
            stochastic) and Sylvie-A (``BoundedStaleness(eps_s=4)``, 1 bit,
            stochastic), random weights from seed 0. Every kernel's count
            is zeroed before each epoch and read after it: the counts must
            equal ``TRAIN_LAUNCHES[(arch, run, step)]`` exactly. Prints the
            median epoch ms of sync and async epochs (epoch 0 left out), the
            first, last and least loss (finite; the last below the first but
            for GAT at 1 bit, which does not train at these widths in the
            reference either: ``GAT_ONE_BIT``),
            validation accuracy, payload and error-compensation MB per
            epoch, peak memory, and a profiled sync and async epoch of
            GCN's and GAT's Sylvie-A split by kernel (GAT's must launch no
            index gather: its backward reads alpha through perm_t).
train-kernels — the tensors of one recorded GCN Sylvie-S step: the SpMM over
            the transposed CSR (d = 256) and over the scatter CSR, and
            quantize / dequantize of the site-1 gradient (bits 1/2/4/8,
            stochastic and deterministic, f32 and bf16 scale/zero), each
            bit-equal to its plain version run on the card; the transposed
            SpMM timed beside its bytes bound, its plain version and
            ``torch.sparse.mm`` of Aᵀ.
gat-kernels — the tensors of one recorded GAT Sylvie-S step: each of GAT's
            kernels against its plain version on the card
            (``gat_kernels_phase``: bit for bit, the softmax within rtol
            1e-6, atol 1e-7) and on a second run, ``spmm_csr_heads`` at one
            head against ``spmm_csr``, over the transposed CSR with
            ``w_idx = perm_t`` against the gather + kernel path it
            replaced, ``sddmm_heads`` also at ``SDDMM_SHAPES``,
            ``gat_softmax`` and ``gat_softmax_bwd`` (both modes) also at
            ``GAT_ROW_SHAPES`` (a 50,000-edge row, rows of 0, 1, 128, 129
            edges; 1, 2, 4, 8 heads); CUDA-event times beside the bound,
            the plain version and the library calls (per head for the
            per-head SpMM and the SDDMM; ``torch.sparse.softmax``, its
            backward and ``index_add_`` for the softmax and the two modes
            of its backward), and for those three each phase's device time
            and the CUDA launches a call and a GAT step make.
train-parity — deterministic 6-epoch Sylvie-S and Sylvie-A (eps_s=2) of each
            arch on ``yelp_like@small`` on the card and on the CPU: losses
            allclose at rtol 1e-4, halo caches and gradients allclose but
            for at most 1% of their rows, counted (``train_parity_phase``;
            GAT at 1 bit epoch by epoch from the CPU's state).
analysis  — ``repro_torch.analysis`` on the card (``analysis_phase``): the
            simulated census contracts (``contracts.SIMULATED``; their
            censuses hold kernel launches, RC206 runs the Low-bit Module's
            kernels at bits 1/2/4/8) and one Sylvie-S epoch of GCN 256x2 on
            [train]'s ``reddit_like@paper`` partition (P=4, 1 bit) held to
            the expectation over its own ring buckets, launches exactly
            ``TRAIN_LAUNCHES``' Sylvie-S step. The sharded contracts
            (``contracts.SHARDED``) run in [sharded]'s spawn, (f) below;
            after [sharded-serve] one ``[analysis]`` line gives the
            contracts run, the findings (0: any finding fails the script)
            and the seconds.

Run time on an H100: about twelve to fifteen minutes of command, the
kernels' build included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tools"))
from torch_timing import (cuda_ms, device_ms, flex_attention_ms,  # noqa
                          kernel_times, sdpa_backward_ms,
                          softmax_library_ms)

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12      # H100 SXM TF32 on the tensor cores, dense
SEED = 0
SWEEP_D = (1, 3, 31, 32, 33, 75, 255, 256, 288, 600, 602, 1433, 4099)
TRAIN_EPOCHS = 20
TRAIN_ARCHS = ("gcn", "graphsage", "gat")
TRAIN_KERNELS = ("quantize_pack", "unpack_dequantize", "spmm_csr",
                 "spmm_csr_heads", "gat_softmax", "sddmm_heads",
                 "gat_softmax_bwd")
# kernel launches per training step (2 layers), by (arch, run, step), in
# TRAIN_KERNELS order. GCN and GraphSAGE (whose mean is the SpMM over the
# unit-weight CSR): forward 2 SpMM; backward 1 SpMM over the transposed CSR
# and 1 over the scatter CSR; quantize/dequantize once per exchange: the
# forward at both sites, the backward at site 1 alone, sync or async (site
# 0's h is the input: it has no gradient exchange, and an async step wires
# it no gslot, so layer 0's table needs no transposed SpMM), none at 32
# bits.
# GAT exchanges hw = h @ w, which has a gradient at site 0 too: both sites
# exchange both ways and scatter a gradient in either step; per layer 1
# softmax and 1 per-head SpMM forward, and backward 1 per-head SpMM over the
# transposed CSR, 1 SDDMM and 2 softmax-backward launches (the forward CSR,
# then the transposed row sums).
# GAT exchanges the projected features its attention scores come from, and
# at 1 bit with stochastic rounding that noise enters the softmax's exponent:
# at the paper's widths its loss starts several times higher and rises, in
# the JAX reference as in the port
# (tests/test_torch_train_sage_gat.py::
# test_gat_at_paper_widths_fails_to_train_at_one_bit_as_jax_does). These
# runs are held to finite losses and exact launches, not to falling losses.
GAT_ONE_BIT = (("gat", "sylvie_s"), ("gat", "sylvie_a"))
_GCN_LAUNCHES = {("vanilla", "sync"): (0, 0, 4, 0, 0, 0, 0),
                 ("sylvie_s", "sync"): (3, 3, 4, 0, 0, 0, 0),
                 ("sylvie_a", "sync"): (3, 3, 4, 0, 0, 0, 0),
                 ("sylvie_a", "async"): (3, 3, 4, 0, 0, 0, 0)}
TRAIN_LAUNCHES = {
    **{("gcn",) + k: v for k, v in _GCN_LAUNCHES.items()},
    **{("graphsage",) + k: v for k, v in _GCN_LAUNCHES.items()},
    ("gat", "vanilla", "sync"): (0, 0, 2, 4, 2, 2, 4),
    ("gat", "sylvie_s", "sync"): (4, 4, 2, 4, 2, 2, 4),
    ("gat", "sylvie_a", "sync"): (4, 4, 2, 4, 2, 2, 4),
    ("gat", "sylvie_a", "async"): (4, 4, 2, 4, 2, 2, 4)}
# [zoo]: the JAX package's PNA, MeshGraphNet, SchNet and NequIP at their
# published widths (the configs of the port's registry), P = 4, seed 0,
# trained ZOO_EPOCHS epochs each of vanilla, Sylvie-S and Sylvie-A, on the
# graph and with the Adam rate given. At the trainer's default Adam 1e-2 the
# first updates overshoot (on the CPU, 10 vanilla epochs: PNA 4.8 -> 132 ->
# 1.2 on yelp_like@small, SchNet 14.9 -> 210 -> 59 on molecule_like@paper);
# at 1e-3 both fall. MeshGraphNet as the reference defines it (15 residual
# MLP layers, no normalization) starts at a loss of ~1e7 and diverges at
# 1e-2 in both packages; at 1e-5 its loss falls epoch by epoch. NequIP's
# falls at 1e-2 (on the CPU, 10 vanilla epochs on molecule_like@paper:
# 1.3948 -> 0.9136; 1e-3 1.3948 -> 1.3679).
ZOO_EPOCHS = 10
ZOO_ARCHS = {"pna": ("reddit_like@paper", 1e-3),
             "meshgraphnet": ("mesh_like@paper", 1e-5),
             "schnet": ("molecule_like@paper", 1e-3),
             "nequip": ("molecule_like@paper", 1e-2)}
ZOO_SMOKE = {"pna": "yelp_like@smoke", "meshgraphnet": "mesh_like@smoke",
             "schnet": "molecule_like@smoke", "nequip": "molecule_like@smoke"}
# NequIP at full width on a larger graph: one warm Sylvie-A sync epoch,
# then one profiled epoch (20,000 nodes, 419,018 edges with self-loops;
# random positions from default_rng(0), as gnn_graph gives them)
ZOO_WIDE = ("nequip", "yelp_like@paper")
# atol of the reduced configs' 32-bit logits, card against the CPU (rtol
# 1e-5). The aggregations are bit-equal on both; the products (cuBLAS, the
# CPU's BLAS) are ulps apart.
ZOO_PARITY_ATOL = 1e-5
ZOO_KERNELS = ("quantize_pack", "unpack_dequantize", "spmm_csr",
               "seg_max_min_csr", "seg_max_min_bwd_csr")
# kernel launches per training step of the full configs, by (arch, run,
# step), in ZOO_KERNELS order (tests/test_torch_zoo.py holds the plain
# versions to the same counts). Every site's input has a gradient, so at
# 1 bit each of the L sites quantizes and dequantizes forward and backward,
# sync or async. SpMM per layer: PNA 3 forward (the mean's sum and the two
# sums of std) and 3 backward (gather_src's over ecsr_t, gather_dst's over
# ecsr, the boundary scatter); MeshGraphNet 1 + 3; SchNet 1 + 2 (no
# gather_dst); NequIP 1 + 2 (one agg_sum over the flat irreps, where the
# reference sums each l apart). seg_max_min: PNA's max and min at each
# layer, forward and backward.
_ZOO_STEP = {"pna": (4, (2, 6, 1)), "meshgraphnet": (15, (2, 4, 0)),
             "schnet": (3, (2, 3, 0)), "nequip": (5, (2, 3, 0))}


def zoo_step_launches(arch: str, run: str, n_layers: int) -> tuple:
    """Launches of one training step of ``arch`` at ``n_layers`` layers (any
    mode), in ``ZOO_KERNELS`` order."""
    q, s, m = _ZOO_STEP[arch][1]
    n = n_layers
    return (0 if run == "vanilla" else q * n,
            0 if run == "vanilla" else q * n, s * n, m * n, m * n)


ZOO_LAUNCHES = {
    (arch, run, mode): zoo_step_launches(arch, run, n)
    for arch, (n, _) in _ZOO_STEP.items()
    for run, mode in (("vanilla", "sync"), ("sylvie_s", "sync"),
                      ("sylvie_a", "sync"), ("sylvie_a", "async"))}
# kernel launches per serving sweep (full or delta), in TRAIN_KERNELS order:
# one quantize and one dequantize per exchange site; GCN and GraphSAGE
# aggregate by one SpMM per layer, GAT by one softmax and one per-head SpMM
# (tests/test_torch_serve_front.py holds the plain versions to the same
# counts)
SERVE_LAUNCHES = {"gcn": (2, 2, 2, 0, 0, 0, 0),
                  "graphsage": (2, 2, 2, 0, 0, 0, 0),
                  "gat": (2, 2, 0, 2, 2, 0, 0)}
# [dlrm] and [dlrm-sharded]: kernel launches per step, in DLRM_KERNELS
# order, by (path, bits of the embedding exchange). One SpMM a training
# step: the table's gradient over the batch's transposed id CSR (the
# MLPerf bags are one-hot; multi-hot bags are summed in plain order). At 1
# bit each rank quantizes its cotangent once and dequantizes the gathered
# one once; one process, 16 and 32 bits quantize nothing, and serving and
# retrieval take no gradient (tests/test_torch_dlrm.py and
# tests/test_torch_sharded_dlrm.py hold the plain versions to the same
# counts)
DLRM_KERNELS = ("quantize_pack", "unpack_dequantize", "spmm_csr")
DLRM_LAUNCHES = {("train", None): (0, 0, 1),
                 ("train_sharded", 32): (0, 0, 1),
                 ("train_sharded", 16): (0, 0, 1),
                 ("train_sharded", 1): (1, 1, 1),
                 ("serve", None): (0, 0, 0),
                 ("retrieval", None): (0, 0, 0)}

def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a signed zero or a NaN included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(as_int), b.view(as_int))


def shifted(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts one element into its buffer."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def check_quant(qops, qref, h, u, bits: int, tag: str,
                shift_payload: bool = False) -> tuple[float, float]:
    """Quantize ``h`` (noise ``u`` or ``None``) with the kernel, scale/zero
    in float32 and in bfloat16, and dequantize each result: all bit-equal to
    the plain versions (bfloat16 to the float32 ones cast by torch). Returns
    the largest differences seen by quantize and by dequantize (0 and 0 when
    the checks pass)."""
    d = h.shape[1]
    pk, sk, zk = qops.quantize_pack_rows(h, u, bits)
    pr, sr, zr = qref.quantize_pack_ref(h, u, bits)
    for what, a, b in (("payload", pk, pr), ("scale", sk, sr), ("zero", zk, zr)):
        check(same_bits(a, b), f"quantize {tag} bits {bits} stochastic "
              f"{u is not None}: {what} bit-equal")
    pb, sb, zb = qops.quantize_pack_rows(h, u, bits, torch.bfloat16)
    for what, a, b in (("payload", pb, pk), ("scale", sb, sk.bfloat16()),
                       ("zero", zb, zk.bfloat16())):
        check(same_bits(a, b), f"quantize {tag} bits {bits} bf16 scale: "
              f"{what} equals the float32 result cast by torch")
    src = shifted(pk) if shift_payload else pk
    deq_err = 0.0
    for s_, z_ in ((sk, zk), (sb, zb)):
        ok = qops.dequantize_rows(src, s_, z_, bits, d)
        orf = qref.unpack_dequantize_ref(pk, s_.float(), z_.float(), bits, d)
        check(same_bits(ok, orf), f"dequantize {tag} bits {bits} "
              f"{s_.dtype}: bit-equal")
        deq_err = max(deq_err, float((ok - orf).abs().max()))
    return max(float((pk.int() - pr.int()).abs().max()),
               float((sk - sr).abs().max()),
               float((zk - zr).abs().max())), deq_err


def quant_shape_sweep(qops, qref) -> int:
    """Both Low-bit Module kernels against their plain versions over edge
    shapes: d in ``SWEEP_D`` (one value; one past a 32-lane chunk; rows
    whose packed width is not a multiple of 4; rows wider than the kernel
    stages through shared memory), rows 1/7/1,000, bits 1/2/4/8, stochastic and
    deterministic, for a contiguous h, a view one element into its buffer,
    and half the rows constant (rng = 0). Returns the cases checked."""
    gen = torch.Generator("cuda").manual_seed(SEED)
    n = 0
    for rows in (1, 7, 1000):
        for d in SWEEP_D:
            x = torch.randn(rows * d + 1, generator=gen, device="cuda")
            r = torch.rand(rows * d + 1, generator=gen, device="cuda")
            flat = x[:-1].view(rows, d).clone()
            flat[::2] = 0.37
            cases = (("contiguous", x[:-1].view(rows, d), r[:-1].view(rows, d)),
                     ("offset", x[1:].view(rows, d), r[1:].view(rows, d)),
                     ("constant rows", flat, r[:-1].view(rows, d)))
            for tag, h, u in cases:
                for bits in (1, 2, 4, 8):
                    for stochastic in (False, True):
                        check_quant(qops, qref, h, u if stochastic else None,
                                    bits, f"{tag} ({rows} x {d})",
                                    shift_payload=tag == "offset")
                        n += 1
    return n


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, "bytes" | "operations") on the card for the same work."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def range_ms(prof, label: str) -> dict:
    """Device ms of the kernels launched inside a profile's ``label`` ranges
    (``record_function``), and of the backward of the operations run there:
    autograd's ``evaluate_function`` events carry the sequence number and
    the thread of the forward operation they differentiate."""
    from torch.autograd import DeviceType

    def walk(ev):
        yield ev
        for ch in ev.cpu_children:
            yield from walk(ch)

    events = prof.events()
    ranges = [r for r in events
              if r.name == label and r.device_type == DeviceType.CPU]
    fwd = [e for r in ranges for e in walk(r)]
    seqs = {(e.sequence_nr, e.thread) for e in fwd if e.sequence_nr >= 0}
    bwd = [e for r in events
           if r.name.startswith("autograd::engine::evaluate_function")
           and (r.sequence_nr, getattr(r, "fwd_thread", None)) in seqs
           for e in walk(r)]

    def ms(evs):
        return sum(k.duration for e in evs for k in e.kernels) / 1e3
    return dict(calls=len(ranges), fwd_ms=ms(fwd), bwd_ms=ms(bwd),
                ms=ms(fwd) + ms(bwd),
                fwd_kernels=sum(len(e.kernels) for e in fwd),
                bwd_kernels=sum(len(e.kernels) for e in bwd))


@contextlib.contextmanager
def marked(owner, name: str, label: str):
    """``owner.name`` run inside a ``record_function(label)`` range (for
    :func:`range_ms`); restored on exit."""
    from torch.profiler import record_function
    real = getattr(owner, name)

    def wrapper(*args, **kwargs):
        with record_function(label):
            return real(*args, **kwargs)
    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, real)


def profile_device(fn, label: str, marks: dict | None = None):
    """Run ``fn`` once under ``torch.profiler``; print its device time by
    kernel and return (fn's result, host ms, device-busy ms, {group: ms},
    {kernel: launches}) with the groups flash kernel / flash backward /
    SpMM / GAT kernels / seg_max (forward) / seg_bwd / quantize / dequantize
    / matrix products (cuBLAS) / everything else. Each label of ``marks``
    gets :func:`range_ms` of its ranges (they overlap the groups)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # a range shows on the device's timeline too, spanning its kernels
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.key not in (marks or {})]
    busy = sum(e.self_device_time_total for e in on_dev) / 1e3
    groups = {"flash": 0.0, "flash_bwd": 0.0, "spmm": 0.0, "gat": 0.0,
              "seg_max": 0.0, "seg_bwd": 0.0, "quantize": 0.0,
              "dequantize": 0.0, "gemm": 0.0, "other": 0.0}
    for e in on_dev:
        name = e.key.lower()
        g = "flash" if "flash_fwd_kernel" in name else \
            "flash_bwd" if "flash_bwd_" in name else \
            "spmm" if "spmm_" in name else \
            "seg_bwd" if "seg_max_min_bwd_" in name else \
            "seg_max" if "seg_max_" in name else \
            "gat" if any(w in name for w in ("rows_unit_kernel",
                                             "rows_segment_kernel",
                                             "rows_long_kernel",
                                             "sddmm_kernel")) else \
            "quantize" if "quantize_pack_" in name else \
            "dequantize" if "unpack_dequantize" in name else \
            "gemm" if any(w in name for w in ("gemm", "gemv", "cutlass",
                                              "xmma", "cublas")) else "other"
        groups[g] += e.self_device_time_total / 1e3
    log(f"[profile] {label}: host {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}% of the host time); by group "
        f"{json.dumps({k: round(v, 3) for k, v in groups.items()})}")
    for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:100]}")
    for mark in marks or {}:
        marks[mark] = range_ms(prof, mark)
        log(f"[profile]   inside {mark!r} (and its backward): "
            f"{json.dumps(marks[mark])}")
    return out, wall, busy, groups, {e.key: e.count for e in on_dev}


def lm_phase(all_kernels: dict) -> dict:
    """granite-3-2b at full width served through ``generate``; returns the
    path's launch counts and layer 0's q/k/v for the kernel checks."""
    from repro_torch import configs
    from repro_torch.dist.runtime import resolve_device
    from repro_torch.launch.train import generate
    from repro_torch.models.lm import model as LM

    dev = resolve_device()
    cfg = configs.get("granite-3-2b").config()
    check(cfg.n_layers == 40 and cfg.param_count() == 2_533_531_648,
          "granite-3-2b full config: 40 layers, 2,533,531,648 parameters")
    t0 = time.perf_counter()
    params = LM.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                            dtype=torch.float32)
    torch.cuda.synchronize()
    n_alloc = sum(t.numel() for _, t in LM.tree_leaves(params))
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.segments[0].layers[0].attn.n_heads} heads / "
        f"{cfg.segments[0].layers[0].attn.n_kv_heads} KV heads, "
        f"{cfg.param_count()} parameters ({n_alloc} allocated with the "
        f"padded vocab), float32 {n_alloc * 4 / 1e9:.2f} GB, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    b, s_ctx, new = 8, 2016, 32
    log(f"[lm] batch {b}, prompt {s_ctx} + {new} new tokens: one prefill over "
        f"{s_ctx + new} positions, {new - 1} decode steps (cut from "
        f"prefill_32k/decode_32k: seq 32768, batch 32/128)")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (b, s_ctx))
    torch.cuda.reset_peak_memory_stats()
    for meta in all_kernels.values():
        meta["k"].launches = 0
    res = generate(params, cfg, prompts, new)
    torch.cuda.synchronize()
    launches = {name: meta["k"].launches for name, meta in all_kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"[lm] generate (first): prefill {res.prefill_s * 1e3:.1f} ms, "
        f"{new - 1} decode steps {res.decode_s * 1e3:.1f} ms; launches "
        f"{launches}; peak memory {peak / 1e9:.2f} GB")
    check(launches["flash_fwd"] == cfg.n_layers,
          f"flash_fwd launched {launches['flash_fwd']} times in one generate,"
          f" expected {cfg.n_layers} (one per prefill layer, none in decode)")
    check(all(n == 0 for name, n in launches.items() if name != "flash_fwd"),
          "the LM path launches no GCN kernel")
    check(res.tokens.shape == (b, new) and res.tokens.min() >= 0
          and res.tokens.max() < cfg.vocab, "greedy tokens in the vocab")
    warm = generate(params, cfg, prompts, new)
    check(np.array_equal(warm.tokens, res.tokens), "greedy tokens repeat")
    log(f"[lm] generate (second): prefill {warm.prefill_s * 1e3:.1f} ms "
        f"({b * (s_ctx + new) / warm.prefill_s:.0f} tokens/s), decode "
        f"{b * (new - 1) / warm.decode_s:.1f} tokens/s "
        f"({warm.decode_s / (new - 1) * 1e3:.2f} ms a step); first tokens of "
        f"each row: {res.tokens[:, :8].tolist()}")

    tokens = torch.zeros((b, s_ctx + new), dtype=torch.long, device=dev)
    tokens[:, :s_ctx] = torch.as_tensor(prompts)
    prefill = LM.make_prefill_step(cfg, b, s_ctx + new)
    (last, caches), *prof_p = profile_device(
        lambda: prefill(params, tokens), f"one prefill ({b}x{s_ctx + new})")
    check(tuple(last.shape) == (b, cfg.vocab)
          and bool(torch.isfinite(last).all()), "prefill logits finite")
    check(np.array_equal(last.argmax(-1).cpu().numpy(), res.tokens[:, 0]),
          "prefill argmax == first generated token")
    decode = LM.make_decode_step(cfg)
    _, *prof_d = profile_device(
        lambda: decode(params, caches, last.argmax(-1)[:, None], s_ctx),
        "one decode step")

    a = cfg.segments[0].layers[0].attn
    w = sum(t.numel() for _, t in LM.tree_leaves(params["seg0"])
            if t.dim() == 3)                  # the layers' weight matrices
    gemm_tflop = 2 * w * b * (s_ctx + new) / 1e12
    gemm_ms = prof_p[2]["gemm"]
    log(f"[lm] prefill matrix products: {gemm_tflop:.3f} TFLOP in "
        f"{gemm_ms:.1f} ms of cuBLAS = {gemm_tflop / gemm_ms * 1e3:.1f} "
        f"TFLOP/s (float32, not on the tensor cores: 67 TFLOP/s peak)")
    step_bytes = 4 * (w + params["embed"].numel()) + sum(
        c.numel() * c.element_size() for _, c in LM.tree_leaves(caches))
    step_bound, _ = bound(step_bytes, 0)
    log(f"[lm] one decode step reads at least {step_bytes / 1e9:.3f} GB "
        f"(float32 weights, bf16 caches) = {step_bound:.3f} ms at 3.35 TB/s;"
        f" device busy {prof_d[1]:.3f} ms, host {prof_d[0]:.3f} ms")
    p0 = LM.index_layer(params["seg0"], 0)["sub0"]
    h = LM.rms_norm(params["embed"][tokens], p0["ln_attn"], cfg.norm_eps)
    qkv = LM.project_qkv(p0["attn"], h, a,
                          torch.arange(s_ctx + new, device=dev))
    return dict(launches=launches, qkv=qkv)


LM_SMALL_ARCHS = ("granite-3-2b", "yi-34b", "olmoe-1b-7b", "deepseek-v2-236b",
                  "gemma2-27b")


def lm_small_phase() -> None:
    """Every LM's reduced config: card vs the CPU's plain versions."""
    from repro_torch import configs
    from repro_torch.launch.train import generate
    from repro_torch.models.convert import (lm_params_from_numpy,
                                            lm_params_to_numpy)
    from repro_torch.models.lm import model as LM

    for arch in LM_SMALL_ARCHS:
        cfg = configs.get(arch).reduced()
        tree = lm_params_to_numpy(LM.init_params(
            cfg, torch.Generator().manual_seed(SEED), dtype=torch.float32))
        b, s_ctx, new = 4, 56, 8
        prompts = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                       (b, s_ctx))
        out = {}
        for dev in ("cuda", "cpu"):
            params = lm_params_from_numpy(tree, cfg, device=dev)
            tok = torch.zeros((b, s_ctx + new), dtype=torch.long, device=dev)
            tok[:, :s_ctx] = torch.as_tensor(prompts)
            last, _ = LM.make_prefill_step(cfg, b, s_ctx + new)(params, tok)
            out[dev] = (last.cpu(),
                        generate(params, cfg, prompts, new, dev).tokens)
        err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        check(torch.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                             atol=1e-4),
              f"{arch} reduced: prefill logits card vs CPU (max abs err {err})")
        check(np.array_equal(out["cuda"][1], out["cpu"][1]),
              f"{arch} reduced: greedy tokens card == CPU")
        log(f"[lm-small] {cfg.name}: prefill logits card vs CPU max abs err "
            f"{err:.3g} (rtol/atol 1e-4); {b}x{new} greedy tokens equal")


# [lm-moe]: (arch, depth cut or None, batch, prompt, parameters, flash
# launches per prefill). The cut is the reference's launch/cells.py
# _reduce_depth: every segment of count > 1 cut to the depth.
LM_MOE_RUNS = (("olmoe-1b-7b", None, 8, 2016, 6_919_096_320, 16),
               ("deepseek-v2-236b", 2, 8, 2016, 9_330_789_376, 3),
               ("gemma2-27b", 2, 2, 6112, 3_444_650_496, 4))
LM_MOE_NEW = 32
PLAIN_SCORES_GB = 2.0


def lm_moe_phase(all_kernels: dict) -> dict:
    """olmoe-1b-7b at its full config, deepseek-v2-236b and gemma2-27b at
    their published widths with the depth cut of ``LM_MOE_RUNS``, each
    served through ``generate`` and freed before the next. Returns each
    run's launches and numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.dist.runtime import resolve_device
    from repro_torch.launch.train import generate
    from repro_torch.models.lm import model as LM

    dev = resolve_device()
    out = {}
    for arch, depth, b, s_ctx, n_params, n_flash in LM_MOE_RUNS:
        t0 = time.perf_counter()
        cfg = cut_config(configs.get(arch).config(), depth)
        check(cfg.param_count() == n_params and cfg.n_layers == n_flash,
              f"{arch}: {cfg.n_layers} layers, {cfg.param_count()} parameters"
              f" (expected {n_flash}, {n_params})")
        n_moe = sum(sg.count for sg in cfg.segments
                    for lc in sg.layers if lc.moe is not None)
        params = LM.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                dtype=torch.float32)
        torch.cuda.synchronize()
        n_alloc = sum(t.numel() for _, t in LM.tree_leaves(params))
        new = LM_MOE_NEW
        log(f"[lm-moe] {arch}: {cfg.n_layers} layers ({[sg.count for sg in cfg.segments]}"
            f" per segment), d_model {cfg.d_model}, {cfg.param_count()} "
            f"parameters ({cfg.param_count(True)} active), {n_alloc} "
            f"allocated with the padded vocab, float32 {n_alloc * 4 / 1e9:.2f}"
            f" GB, drawn in {time.perf_counter() - t0:.1f} s; batch {b}, "
            f"prompt {s_ctx} + {new} new tokens")
        prompts = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                       (b, s_ctx))
        torch.cuda.reset_peak_memory_stats()
        for meta in all_kernels.values():
            meta["k"].launches = 0
        res = generate(params, cfg, prompts, new)
        torch.cuda.synchronize()
        launches = {name: meta["k"].launches
                    for name, meta in all_kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        check(launches["flash_fwd"] == n_flash,
              f"{arch}: flash_fwd launched {launches['flash_fwd']} times in "
              f"one generate, expected {n_flash} (one per prefill layer)")
        check(all(n == 0 for name, n in launches.items()
                  if name != "flash_fwd"),
              f"{arch}: the LM path launches no other kernel")
        check(res.tokens.shape == (b, new) and res.tokens.min() >= 0
              and res.tokens.max() < cfg.vocab,
              f"{arch}: greedy tokens in the vocab")
        warm = generate(params, cfg, prompts, new)
        check(np.array_equal(warm.tokens, res.tokens),
              f"{arch}: greedy tokens repeat")
        run = dict(layers=cfg.n_layers, params=cfg.param_count(),
                   batch=b, prompt=s_ctx, new=new, launches=launches,
                   prefill_ms=warm.prefill_s * 1e3,
                   first_prefill_ms=res.prefill_s * 1e3,
                   decode_tok_s=b * (new - 1) / warm.decode_s,
                   decode_step_ms=warm.decode_s / (new - 1) * 1e3,
                   peak_gb=peak / 1e9)
        log(f"[lm-moe] {arch}: generate (first) prefill "
            f"{res.prefill_s * 1e3:.1f} ms; (second) prefill "
            f"{run['prefill_ms']:.1f} ms, decode {run['decode_tok_s']:.1f} "
            f"tokens/s ({run['decode_step_ms']:.2f} ms a step); peak "
            f"{run['peak_gb']:.2f} GB; flash launches {n_flash}; first tokens"
            f" {res.tokens[:, :8].tolist()}")

        # dropped assignments per MoE layer, in a third generate that counts
        # them (host syncs; untimed): the first n_moe calls are the prefill
        if n_moe:
            calls = []
            real = LM.moe_ffn

            def counted(p, x, m, capacity=None):
                gate_i = LM.moe_route(p, x, m)[2]
                keep, _, (ng, c) = LM.moe_dispatch(gate_i, m, capacity)
                calls.append((keep.numel(), int((~keep).sum()), ng, c))
                return real(p, x, m, capacity)
            LM.moe_ffn = counted
            try:
                third = generate(params, cfg, prompts, new)
            finally:
                LM.moe_ffn = real
            check(np.array_equal(third.tokens, res.tokens),
                  f"{arch}: greedy tokens repeat while drops are counted")
            check(len(calls) == n_moe * new, f"{arch}: {len(calls)} MoE "
                  f"calls in a generate, expected {n_moe * new}")
            pre, dec = calls[:n_moe], calls[n_moe:]
            run["moe_prefill"] = dict(
                assignments=pre[0][0], groups=pre[0][2], capacity=pre[0][3],
                dropped=[c[1] for c in pre])
            run["moe_decode"] = dict(
                assignments_per_step=dec[0][0], groups=dec[0][2],
                capacity=dec[0][3],
                dropped=[sum(c[1] for c in dec[i::n_moe])
                         for i in range(n_moe)])
            log(f"[lm-moe] {arch}: dropped MoE assignments per layer, "
                f"prefill ({pre[0][0]} assignments, {pre[0][2]} groups of "
                f"capacity {pre[0][3]}): {run['moe_prefill']['dropped']}; "
                f"decode, summed over {new - 1} steps ({dec[0][0]} "
                f"assignments a step, {dec[0][2]} group of capacity "
                f"{dec[0][3]}): {run['moe_decode']['dropped']}")

        # one prefill profiled, the expert products and the MoE FFNs marked
        tokens = torch.zeros((b, s_ctx + new), dtype=torch.long, device=dev)
        tokens[:, :s_ctx] = torch.as_tensor(prompts)
        prefill = LM.make_prefill_step(cfg, b, s_ctx + new)
        torch.cuda.synchronize()
        with marked(LM, "moe_ffn", "lm_moe_ffn"), \
                marked(LM, "expert_ffn", "lm_moe_experts"), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            last, caches = prefill(params, tokens)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t1) * 1e3
        split = dict(host_ms=host_ms, **prefill_split(prof))
        check(tuple(last.shape) == (b, cfg.vocab)
              and bool(torch.isfinite(last).all()),
              f"{arch}: prefill logits finite")
        check(np.array_equal(last.argmax(-1).cpu().numpy(), res.tokens[:, 0]),
              f"{arch}: prefill argmax == first generated token")
        if n_moe:
            m = next(lc.moe for sg in cfg.segments for lc in sg.layers
                     if lc.moe is not None)
            rows = m.n_experts * run["moe_prefill"]["groups"] \
                * run["moe_prefill"]["capacity"]
            split["experts_tflop"] = 6 * rows * cfg.d_model * m.d_ff \
                * n_moe / 1e12
            split["experts_cublas_tflop_s"] = split["experts_tflop"] / max(
                split["experts_cublas_ms"], 1e-9) * 1e3
        run["prefill_profile"] = split
        log(f"[lm-moe] {arch}: profiled prefill {json.dumps(split)}")

        # the same prefill with the plain attention in place of the kernel
        # (``plain_attention_logits``)
        run["plain_attention"] = plain_attention_logits(
            arch, cfg, params, prefill, tokens, b, s_ctx + new, bool(n_moe))
        decode = LM.make_decode_step(cfg)
        _, *prof_d = profile_device(
            lambda: decode(params, caches, last.argmax(-1)[:, None], s_ctx),
            f"{arch}: one decode step")
        run["decode_host_ms"], run["decode_busy_ms"] = prof_d[0], prof_d[1]
        out[arch] = run
        del params, caches, last, prefill, decode, tokens
        torch.cuda.empty_cache()
    return out


def plain_attention_logits(arch, cfg, params, prefill, tokens, b, seq,
                           moe: bool):
    """Prefill twice more, with the kernel and with the plain attention
    (``attention_bshd_ref``) in place of it, and compare the last-position
    logits within 1e-4 x max(1, largest |logit|), a check that holds
    whatever the greedy tokens are (gemma2's are all 0). For a MoE model
    the plain prefill takes the kernel prefill's routing
    (``carried_routes``): top-k and the capacity cut are not continuous, and
    a rounding of the attention would reroute tokens; the line gives how
    many of its own top-k assignments differ. Where the plain version's
    (B, H, S, 1,024-key) float32 score block passes ``PLAIN_SCORES_GB``
    (deepseek-v2: 8.6 GB, several alive at once, on a 52.75 GB peak), each
    flash call of the kernel prefill is held to the plain version over its
    first ``LM_TRAIN_HEADS`` heads instead (``head_slice_check``)."""
    from repro_torch.kernels.flash import ref as fref
    from repro_torch.models.lm import model as LM

    heads = max(lc.attn.n_heads for sg in cfg.segments for lc in sg.layers)
    score_gb = b * heads * seq * 1024 * 4 / 1e9
    if score_gb > PLAIN_SCORES_GB:
        real = LM.attention_bshd
        calls = []

        def checked(q, k, v, **kw):
            calls.append(head_slice_check(q, k, v, kw, LM_TRAIN_HEADS))
            return real(q, k, v, **kw)
        LM.attention_bshd = checked
        try:
            prefill(params, tokens)
        finally:
            LM.attention_bshd = real
        log(f"[lm-moe] {arch}: its score block is {score_gb:.1f} GB (> "
            f"{PLAIN_SCORES_GB}): each of the prefill's {len(calls)} flash "
            f"calls against plain attention over {calls[0]['heads']} heads:"
            f" max abs err {[c['out_max_abs_err'] for c in calls]} (tol "
            f"1e-4)")
        return dict(calls=calls)
    real_attn = LM.attention_bshd
    routes, moved = [], []
    with carried_routes(routes, False, moved):
        last = prefill(params, tokens)[0]
    LM.attention_bshd = fref.attention_bshd_ref
    try:
        with carried_routes(routes, True, moved):
            last_p = prefill(params, tokens)[0]
    finally:
        LM.attention_bshd = real_attn
    top = float(last_p.abs().max())
    err = float((last - last_p).abs().max())
    check(err <= 1e-4 * max(1.0, top), f"{arch}: prefill logits with the"
          f" kernel within 1e-4 x max(1, {top:.4g}) of those with the "
          f"plain attention (max abs err {err})")
    total = sum(r.numel() for r in routes)
    log(f"[lm-moe] {arch}: prefill logits, kernel against plain attention: "
        f"max abs err {err:.3g} (largest logit {top:.4g}, tol 1e-4 x max(1,"
        f" largest))" + (f"; the kernel prefill's routing carried across: "
                         f"{sum(moved)} of {total} top-k assignments of the "
                         f"plain prefill's own would differ" if moe else ""))
    return dict(max_abs_err=err, max_abs_logit=top, gated=True,
                **({"assignments_moved": sum(moved), "assignments": total}
                   if moe else {}))


def prefill_split(prof) -> dict:
    """A profiled LM prefill's device ms by where each kernel was launched:
    the flash kernel; the MoE expert products (inside the
    ``lm_moe_experts`` ranges: three batched cuBLAS products, the SiLU
    gate); the rest of the MoE FFN (inside ``lm_moe_ffn``, outside the
    experts: router, top-k, the dispatch's cumsum, copies and gathers, the
    shared experts); everything else (attention projections, norms, the
    dense FFNs). Each with its cuBLAS part. The ranges themselves show on
    the device's timeline too (as user annotations spanning their kernels);
    they are left out of the kernels' sum."""
    from torch.autograd import DeviceType

    def is_gemm(name):
        return any(w in name.lower() for w in ("gemm", "gemv", "cutlass",
                                               "xmma", "cublas"))

    def kernels(ev):
        """(name, device us) of every kernel launched under ``ev``."""
        out = [(k.name, k.duration) for k in ev.kernels]
        for ch in ev.cpu_children:
            out += kernels(ch)
        return out

    def ms(ks, gemm_only=False):
        return sum(d for n, d in ks if is_gemm(n) or not gemm_only) / 1e3

    ranges = ("lm_moe_ffn", "lm_moe_experts")
    events = prof.events()
    on_dev = [(e.name, e.device_time_total) for e in events
              if e.device_type == DeviceType.CUDA and e.name not in ranges]
    moe, exp = ([k for e in events if e.name == r
                 and e.device_type == DeviceType.CPU for k in kernels(e)]
                for r in ranges)
    flash = [k for k in on_dev if "flash_fwd_kernel" in k[0]]
    out = dict(device_busy_ms=ms(on_dev), flash_ms=ms(flash),
               experts_ms=ms(exp), experts_cublas_ms=ms(exp, True),
               moe_rest_ms=ms(moe) - ms(exp),
               moe_rest_cublas_ms=ms(moe, True) - ms(exp, True),
               other_ms=ms(on_dev) - ms(moe) - ms(flash),
               other_cublas_ms=ms(on_dev, True) - ms(moe, True))
    top: dict = {}
    for name, d in on_dev:
        top[name[:80]] = top.get(name[:80], 0.0) + d / 1e3
    out["top_kernels_ms"] = dict(sorted(top.items(), key=lambda t: -t[1])[:6])
    return out


def flash_phase(q, k, v) -> dict:
    """The flash kernel against its plain versions on layer 0's q/k/v."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.flash import ref as fref

    b, s, h, d = q.shape
    g = h // k.shape[2]
    scale = d ** -0.5

    def heads(x, rep=1):            # (B, S, Hx, D) -> (B*H, S, D)
        x = x.repeat_interleave(rep, dim=2) if rep > 1 else x
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    qf, kf, vf = heads(q), heads(k, g), heads(v, g)

    def compare(tag, qq, kk, vv, tol, window=None, scale=scale):
        acc, m, l = fops.flash_fwd(qq, kk, vv, scale=scale, window=window)
        torch.cuda.synchronize()
        acc_r, m_r, l_r = fref.flash_fwd_ref(qq, kk, vv, scale=scale,
                                             window=window)
        err = float((acc / l[..., None] - acc_r / l_r[..., None]).abs().max())
        check(err <= tol, f"flash {tag}: attention within {tol} of the plain "
              f"version (max abs err {err})")
        check(torch.allclose(m, m_r, rtol=1e-5, atol=1e-5)
              and torch.allclose(l, l_r, rtol=1e-4), f"flash {tag}: m and l")
        log(f"[flash] {tag} {tuple(qq.shape)} {qq.dtype}: attention max abs "
            f"err {err:.3g} (tol {tol}); raw acc "
            f"{float((acc - acc_r).abs().max()):.3g}, "
            f"m {float((m - m_r).abs().max()):.3g}, l relative "
            f"{float(((l - l_r).abs() / l_r).max()):.3g}")
        return err

    errs = [compare("f32", qf, kf, vf, 1e-4),
            compare("bf16 inputs", qf.bfloat16(), kf.bfloat16(),
                    vf.bfloat16(), 2e-2)]
    gen = torch.Generator("cuda").manual_seed(SEED)
    rag = [torch.randn(64, 2080, d, generator=gen, device="cuda")
           for _ in range(3)]
    errs.append(compare("ragged, window 100", *rag, 1e-4, window=100))
    for dd in (1, 75, 200, 256):    # other head widths, other tile shapes
        small = [torch.randn(4, 300, dd, generator=gen, device="cuda")
                 for _ in range(3)]
        errs.append(compare(f"d {dd}, window 37", *small, 1e-4, window=37))
    # d = 128 (yi-34b's head width) at the slice's batch and length
    q128, k128, v128 = (torch.randn(b * h, s, 128, generator=gen,
                                    device="cuda") for _ in range(3))
    errs.append(compare("d 128", q128, k128, v128, 1e-4,
                        scale=128 ** -0.5))

    kw = dict(causal=True, window=None, softcap=None, q_offset=0, kv_len=s,
              scale=scale)
    out = fops.attention_bshd(q, k, v, **kw)
    ref = fref.attention_bshd_ref(q, k, v, **kw)
    bshd_err = float((out - ref).abs().max())
    check(bshd_err <= 1e-4, f"attention_bshd (GQA {g}:1) within 1e-4 of "
          f"blockwise_attention's plain version (max abs err {bshd_err})")
    errs.append(bshd_err)
    log(f"[flash] attention_bshd {tuple(q.shape)} / {tuple(k.shape)} (the "
        f"model's call): max abs err {bshd_err:.3g} (tol 1e-4)")

    pairs = s * (s + 1) // 2                   # causal: keys seen per head
    ops = 4 * d * pairs * b * h
    f_bytes = 4 * (qf.numel() + kf.numel() + vf.numel() + qf.numel()) \
        + 4 * 2 * b * h * s
    fb, fo = bound(f_bytes, 3 * ops, TF32_OPS_PER_S)
    bb, bo = bound(4 * (q.numel() + k.numel() + v.numel() + q.numel()),
                   3 * ops, TF32_OPS_PER_S)
    qs, ks, vs = (x.view(b, h, s, d) for x in (qf, kf, vf))
    q128s, k128s, v128s = (x.view(b, h, s, 128) for x in (q128, k128, v128))
    res = dict(
        shape=[b * h, s, d], max_abs_err=max(errs),
        ms=cuda_ms(lambda: fops.flash_fwd(qf, kf, vf, scale=scale)),
        plain_ms=cuda_ms(lambda: fref.flash_fwd_ref(qf, kf, vf, scale=scale),
                         iters=2, warmup=1),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, scale=scale)),
        bound_ms=fb, bound_by=fo,
        bf16_ms=cuda_ms(lambda: fops.flash_fwd(
            qf.bfloat16(), kf.bfloat16(), vf.bfloat16(), scale=scale)),
        bshd_ms=cuda_ms(lambda: fops.attention_bshd(q, k, v, **kw)),
        bshd_plain_ms=cuda_ms(lambda: fref.attention_bshd_ref(q, k, v, **kw),
                              iters=2, warmup=1),
        bshd_bound_ms=bb, bshd_bound_by=bo, gflop=ops / 1e9,
        gbytes=f_bytes / 1e9, bytes_ms=bound(f_bytes, 0)[0],
        cuda_core_ms=bound(0, ops)[0],
        d128_ms=cuda_ms(lambda: fops.flash_fwd(q128, k128, v128,
                                               scale=128 ** -0.5)),
        d128_library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q128s, k128s, v128s, is_causal=True, scale=128 ** -0.5)),
        d128_bound_ms=bound(4 * 4 * b * h * s * 128 + 4 * 2 * b * h * s,
                            6 * ops, TF32_OPS_PER_S)[0])
    res["lm_shapes"] = flash_lm_shapes()
    res["max_abs_err"] = max(res["max_abs_err"], *(
        c["max_abs_err"] for c in res["lm_shapes"].values()))
    log(f"[flash] times: {json.dumps(res)}")
    return res


def visible_pairs(sq: int, window=None, kv_end=None, causal=True) -> int:
    """(query, key) pairs a causal (windowed) attention over ``sq`` rows
    sees, per head: key j <= i, i - j < window, j < kv_end (none by
    default; without ``causal`` every key j < kv_end, which is then
    needed, with i - j < window)."""
    i = np.arange(sq, dtype=np.int64)
    if not causal:
        hi = np.full_like(i, kv_end)
    else:
        hi = i + 1 if kv_end is None else np.minimum(i + 1, kv_end)
    lo = np.zeros_like(i) if window is None else np.maximum(i - window + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


# (tag, batch, seq, heads, kv heads, d, dv, window, softcap, scale): the
# model's attention_bshd call at gemma2-27b's local and global layers and at
# deepseek-v2-236b's MLA layers (v a column slice of kv, as the model's),
# and the gemma2 shape at scale 1, where scores of ~11 standard deviations
# make the cap bend them
FLASH_LM_SHAPES = (
    ("gemma2 local", 2, 6144, 32, 16, 128, 128, 4096, 50.0, 128 ** -0.5),
    ("gemma2 global", 2, 6144, 32, 16, 128, 128, None, 50.0, 128 ** -0.5),
    ("gemma2 local, scale 1", 2, 6144, 32, 16, 128, 128, 4096, 50.0, 1.0),
    ("deepseek-v2 MLA", 8, 2048, 128, 128, 192, 128, None, None,
     192 ** -0.5))


def flash_lm_shapes() -> dict:
    """The flash kernel through ``attention_bshd`` at the served models'
    layer shapes (``FLASH_LM_SHAPES``), float32 from a seeded generator,
    against ``attention_bshd_ref`` (one batch row at a time) within 1e-4;
    CUDA-event times beside the operations bound (3xTF32 products: 2 (D +
    Dv) flops per visible pair, three TF32 products each), the plain version
    and one library call that computes the same function: under a softcap
    ``flex_attention`` (``torch_timing.flex_attention_ms``; held to the
    plain version within 1e-3), else ``scaled_dot_product_attention`` where
    it takes the case (no window, as many KV heads as query heads)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.flash import ref as fref

    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    out = {}
    for tag, b, s, h, hkv, d, dv, window, cap, scale in FLASH_LM_SHAPES:
        q = torch.randn(b, s, h, d, generator=gen, device="cuda")
        k = torch.randn(b, s, hkv, d, generator=gen, device="cuda")
        if dv < d:      # MLA: k_nope and v are column slices of one kv
            kv = torch.randn(b, s, hkv, dv + dv, generator=gen, device="cuda")
            v = kv[..., dv:]
        else:
            v = torch.randn(b, s, hkv, dv, generator=gen, device="cuda")
        kw = dict(causal=True, window=window, softcap=cap, q_offset=0,
                  kv_len=s, scale=scale)
        got = fops.attention_bshd(q, k, v, **kw)
        torch.cuda.synchronize()

        def plain():
            return torch.cat([fref.attention_bshd_ref(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], **kw) for i in range(b)])
        want = plain()
        err = float((got - want).abs().max())
        check(tuple(got.shape) == (b, s, h, dv) and err <= 1e-4,
              f"flash {tag}: attention_bshd within 1e-4 of its plain version"
              f" (max abs err {err})")
        case = dict(shape=[b, s, h, hkv, d, dv], window=window, softcap=cap,
                    scale=scale, max_abs_err=err)
        if cap:
            bare = fops.attention_bshd(q, k, v, **{**kw, "softcap": None})
            case["cap_moves_output_by"] = float((bare - got).abs().max())
            del bare
        pairs = visible_pairs(s, window) * b * h
        n_bytes = 4 * (q.numel() + k.numel() + v.numel() + b * s * h * dv)
        case["bound_ms"], case["bound_by"] = bound(
            n_bytes, 3 * 2 * (d + dv) * pairs, TF32_OPS_PER_S)
        case["ms"] = cuda_ms(lambda: fops.attention_bshd(q, k, v, **kw))
        case["plain_ms"] = cuda_ms(plain, iters=2, warmup=1)
        case["library_ms"] = None
        if cap:
            case["library_ms"], lib = flex_attention_ms(
                q, k, v, window=window, softcap=cap, scale=scale)
            lib_err = float((lib - want).abs().max())
            check(lib_err <= 1e-3, f"flash {tag}: flex_attention (the "
                  f"yardstick) within 1e-3 of the plain version (max abs err"
                  f" {lib_err})")
            case.update(library="flex_attention", library_max_abs_err=lib_err)
            del lib
        elif window is None and hkv == h:
            qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
            case["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, scale=scale))
            case["library"] = "scaled_dot_product_attention"
        log(f"[flash] {tag}: {json.dumps(case)}")
        out[tag] = case
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return out


# [flash-bwd]: (tag, batch, sq, skv, heads, kv heads, d, dv, window,
# softcap, kv_len (None: skv), scale[, causal (default True)]).
# granite-3-2b's layer call in [lm-train] (batch 4, GQA 32:8, D 64), d =
# 128 without a cap, the served models' shapes of FLASH_LM_SHAPES (gemma2's
# capped local and global layers, deepseek-v2's MLA with v a column slice
# of kv), then edges: rows that see no key (kv_len 100, window 37: rows 136
# on), a window smaller than a tile, Sq and Skv that are no tile multiples,
# the widest head under a cap that bends the scores (scale 1), odd widths;
# and the edges of the tensor-core tiling: GQA groups of 1 and 8, D 32, one
# query row (not causal: a causal row 0 sees key 0 alone, and its dq and dk
# are 0 up to rounding), Skv under one key tile, kv_len inside a tile under
# a window, MLA's column-slice v with Sq no tile multiple
FLASH_BWD_SHAPES = (
    ("granite", 4, 2048, 2048, 32, 8, 64, 64, None, None, None, 64 ** -0.5),
    ("d 128", 4, 2048, 2048, 32, 32, 128, 128, None, None, None,
     128 ** -0.5),
    *((tag, b, s, s, h, hkv, d, dv, window, cap, None, scale)
      for tag, b, s, h, hkv, d, dv, window, cap, scale in FLASH_LM_SHAPES
      if scale != 1.0),
    ("rows that see no key", 2, 300, 300, 4, 2, 64, 64, 37, None, 100,
     0.125),
    ("window 5", 2, 300, 300, 4, 4, 64, 64, 5, None, None, 0.125),
    ("sq 333, skv 410", 2, 333, 410, 4, 2, 64, 64, None, None, None, 0.125),
    ("d 256, softcap 30, window 37, scale 1", 1, 300, 300, 2, 1, 256, 256,
     37, 30.0, None, 1.0),
    ("d 75, dv 33, softcap 20", 2, 130, 130, 3, 1, 75, 33, None, 20.0, None,
     0.2),
    ("gqa group 1", 2, 300, 300, 4, 4, 64, 64, None, None, None, 0.125),
    ("gqa group 8", 2, 300, 300, 8, 1, 64, 64, None, None, None, 0.125),
    ("d 32", 2, 300, 300, 4, 2, 32, 32, None, None, None, 32 ** -0.5),
    ("sq 1, skv 200, not causal", 2, 1, 200, 4, 2, 64, 64, None, None, None,
     0.125, False),
    ("skv 20 under a key tile, sq 100", 2, 100, 20, 4, 2, 64, 64, None, None,
     None, 0.125),
    ("kv_len 77 inside a tile, window 50", 2, 300, 300, 4, 2, 64, 64, 50,
     None, 77, 0.125),
    ("MLA, sq 333", 1, 333, 333, 4, 4, 192, 128, None, None, None,
     192 ** -0.5))
FLASH_BWD_TOL = 1e-4
# the shapes timed beside the library's backward
FLASH_BWD_LIBRARY = ("granite", "d 128",
                     *(t[0] for t in FLASH_LM_SHAPES if t[-1] != 1.0))


def _head_slice(x, n, b, h):
    """The first ``n`` query heads' rows of an lse-shaped (B * H, S)
    tensor."""
    return x.view(b, h, -1)[:, :n].reshape(b * n, -1)


def flash_bwd_phase() -> dict:
    """The flash backward kernels (``flash_bwd_dq``, ``flash_bwd_dkdv``)
    through ``attention_bshd_bwd`` at ``FLASH_BWD_SHAPES``, float32 from a
    seeded generator, on the kernel forward's own output and lse: one
    launch of each kernel a call (their counters), dq, dk and dv each
    within ``FLASH_BWD_TOL`` x the largest magnitude of
    ``attention_bshd_bwd_ref``'s (over the first heads where its score
    blocks pass ``PLAIN_SCORES_GB``), and a second call bit-equal. Times:
    the pair and each kernel alone (through ``bwd_launch_args``) by CUDA
    events, the plain backward, and the library's backward (``scaled_dot_product_
    attention`` without a cap or window, ``flex_attention`` under the cap);
    the operations bound counts the five products of the backward
    (2 (3 D + 2 Dv) flops a visible pair) as 3xTF32, the forward's
    convention; each kernel's own bound counts what its function needs
    (dq: S, dP, dQ; dkdv: S, dP, dV, dK), and ``*_bound_share`` is a bound
    over its time. Where rows see no key (causal, a window and kv_len
    short of Skv), their dq must be exactly 0."""
    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.flash import ref as fref

    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    out = {}
    for (tag, b, sq, skv, h, hkv, d, dv, window, cap, kv_len, scale,
         *causal) in FLASH_BWD_SHAPES:
        causal = causal[0] if causal else True
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda")
        k = torch.randn(b, skv, hkv, d, generator=gen, device="cuda")
        if dv < d:      # MLA: v a column slice of kv, as the model's
            v = torch.randn(b, skv, hkv, 2 * dv, generator=gen,
                            device="cuda")[..., dv:]
        else:
            v = torch.randn(b, skv, hkv, dv, generator=gen, device="cuda")
        d_out = torch.randn(b, sq, h, dv, generator=gen, device="cuda")
        kv_len = skv if kv_len is None else kv_len
        fkw = dict(causal=causal, window=window, softcap=cap, q_offset=0,
                   kv_len=kv_len, block=1024, scale=scale)
        o, lse = fops._bshd_fwd(q, k, v, **fkw, with_lse=True)
        bkw = dict(causal=causal, window=window, softcap=cap, kv_len=kv_len,
                   scale=scale)

        def kernel():
            return fops.attention_bshd_bwd(q, k, v, o, lse, d_out, **bkw)
        for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
            getattr(fops, name.upper()).launches = 0
        got = kernel()
        torch.cuda.synchronize()
        check(fops.FLASH_BWD_DQ.launches == fops.FLASH_BWD_DKDV.launches
              == 1, f"flash-bwd {tag}: one launch of each kernel a call")
        again = kernel()
        torch.cuda.synchronize()
        bits = all(same_bits(a, c) for a, c in zip(got, again))
        check(bits, f"flash-bwd {tag}: two calls bit-equal")
        del again
        # the plain backward, over the first n_kv KV heads and their query
        # heads where its score blocks would pass PLAIN_SCORES_GB
        g = h // hkv
        n_kv = hkv
        while n_kv > 1 and b * n_kv * g * sq * min(1024, skv) * 4 / 1e9 \
                > PLAIN_SCORES_GB:
            n_kv //= 2
        n_h = n_kv * g
        sl = (q[:, :, :n_h], k[:, :, :n_kv], v[:, :, :n_kv], o[:, :, :n_h],
              _head_slice(lse, n_h, b, h), d_out[:, :, :n_h])

        def plain():
            return fref.attention_bshd_bwd_ref(*sl, **bkw)
        want = plain()
        case = dict(shape=[b, sq, skv, h, hkv, d, dv], window=window,
                    softcap=cap, kv_len=kv_len, scale=scale, causal=causal,
                    plain_heads=f"{n_h} of {h}", bit_equal=bits)
        for name, a, w in zip(("dq", "dk", "dv"),
                              (got[0][:, :, :n_h], got[1][:, :, :n_kv],
                               got[2][:, :, :n_kv]), want):
            err = float((a - w).abs().max())
            top = float(w.abs().max())
            case[f"{name}_max_abs_err"] = err
            case[f"{name}_largest"] = top
            check(bool(torch.isfinite(a).all()) and err <= FLASH_BWD_TOL
                  * top, f"flash-bwd {tag}: {name} within {FLASH_BWD_TOL} x "
                  f"{top} of the plain backward (max abs err {err})")
        if causal and window is not None and kv_len < skv:
            rows = torch.arange(sq, device="cuda") >= kv_len - 1 + window
            check(bool((got[0][:, rows] == 0).all()),
                  f"flash-bwd {tag}: dq is 0 on the rows that see no key")
        pairs = visible_pairs(sq, window, min(kv_len, skv),
                              causal) * b * h
        # float32 elements: q (and dq), k (and dk), v (and dv), out or dO,
        # lse or Delta
        nq, nk, nv = q.numel(), k.numel(), b * skv * hkv * dv
        no, nr = b * sq * h * dv, b * h * sq
        case["bound_ms"], case["bound_by"] = bound(
            4 * (2 * nq + 2 * nk + 2 * nv + 2 * no + nr),
            3 * 2 * (3 * d + 2 * dv) * pairs, TF32_OPS_PER_S)
        case["dq_bound_ms"], case["dq_bound_by"] = bound(
            4 * (2 * nq + nk + nv + 2 * no + 2 * nr),
            3 * 2 * (2 * d + dv) * pairs, TF32_OPS_PER_S)
        case["dkdv_bound_ms"], case["dkdv_bound_by"] = bound(
            4 * (nq + 2 * nk + 2 * nv + no + 2 * nr),
            3 * 2 * (2 * d + 2 * dv) * pairs, TF32_OPS_PER_S)
        case["gflop"] = 2 * (3 * d + 2 * dv) * pairs / 1e9
        big = case["gflop"] > 100
        reps = dict(iters=3, warmup=1) if big else {}
        case["ms"] = cuda_ms(kernel, **reps)
        args, keep = fops.bwd_launch_args(q, k, v, o, lse, d_out, **bkw)
        for which, k_ in (("dq", fops.FLASH_BWD_DQ),
                          ("dkdv", fops.FLASH_BWD_DKDV)):
            case[f"{which}_ms"] = cuda_ms(lambda: k_(*args), **reps)
            case[f"{which}_bound_share"] = (case[f"{which}_bound_ms"]
                                            / case[f"{which}_ms"])
        case["bound_share"] = case["bound_ms"] / case["ms"]
        del args, keep
        case["plain_ms"] = cuda_ms(plain, iters=2, warmup=1)
        case["library_ms"] = None
        if tag not in FLASH_BWD_LIBRARY:
            pass            # the edges: widths and masks the library lacks
        elif cap:
            case["library_ms"], lib = flex_attention_ms(
                q, k, v, window=window, softcap=cap, scale=scale,
                d_out=d_out)
            case["library"] = "flex_attention backward"
        elif window is None and kv_len == skv and sq == skv:
            case["library_ms"], lib = sdpa_backward_ms(q, k, v, d_out,
                                                       scale=scale)
            case["library"] = "scaled_dot_product_attention backward"
        if case["library_ms"] is not None:
            lib_err = max(float((a - c).abs().max() / c.abs().max())
                          for a, c in zip(lib, got))
            case["library_max_rel_err"] = lib_err
            check(lib_err <= 1e-3, f"flash-bwd {tag}: the library's backward"
                  f" (the yardstick) within 1e-3 of the kernels' ({lib_err})")
            del lib
        log(f"[flash-bwd] {tag}: {json.dumps(case)}")
        out[tag] = case
        del q, k, v, o, lse, d_out, got, want, sl
        torch.cuda.empty_cache()
    log(f"[flash-bwd] {len(out)} shapes in {time.perf_counter() - t0:.1f} s")
    return out


@contextlib.contextmanager
def recording(owner, name: str, calls: list):
    """Wrap ``owner.name`` so that each call appends its arguments to
    ``calls``, all of them in the signature's order (keywords and defaults
    included); restored on exit."""
    real = getattr(owner, name)
    sig = inspect.signature(real)

    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append(tuple(bound.arguments.values()))
        return real(*args, **kwargs)
    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, real)


def cut_config(cfg, cut):
    """``cfg`` cut in depth: ``None`` keeps it, an int cuts every segment of
    a larger count to it (the reference's ``launch/cells.py::
    _reduce_depth``), ``"seg0"`` keeps segment 0 alone."""
    if cut == "seg0":
        return dataclasses.replace(cfg, segments=cfg.segments[:1])
    if cut is None:
        return cfg
    return dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(sg, count=min(sg.count, cut))
        for sg in cfg.segments))


@contextlib.contextmanager
def carried_routes(routes: list, replay: bool, moved: list):
    """An override of the LM's ``moe_route`` for one run (here, not a model
    flag). Recording (``replay`` False): each call's top-k experts are
    appended to ``routes``. Replaying: each call routes by the next recorded
    experts instead of its own top-k, with gate weights from its own
    probabilities at those experts, renormalised as ``moe_route`` does (the
    same floats where the two agree), and appends to ``moved`` how many of
    its own top-k assignments differ. A run with the plain attention in the
    kernel's place then takes the kernel run's routing and drops: top-k and
    the capacity cut are not continuous, and a rounding of the attention
    would otherwise reroute tokens (1,584 of 2,097,152 in olmoe's
    prefill)."""
    from repro_torch.models.lm import model as LM
    real = LM.moe_route
    it = iter(list(routes))

    def route(p, x, m):
        probs, gate_w, gate_i = real(p, x, m)
        if not replay:
            routes.append(gate_i)
            return probs, gate_w, gate_i
        want = next(it)
        moved.append(int((want != gate_i).sum()))
        w = torch.gather(probs, -1, want)
        return probs, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), want
    LM.moe_route = route
    try:
        yield
    finally:
        LM.moe_route = real
    if replay:
        check(next(it, None) is None and len(moved) == len(routes),
              f"the replayed run routed {len(moved)} times, the recorded "
              f"{len(routes)}")


def head_slice_check(q, k, v, kw, n_heads: int, d_out=None) -> dict:
    """One ``attention_bshd`` call on the card held to its plain version over
    its first ``n_heads`` query heads (and their KV heads), where the plain
    score blocks of all heads would not fit beside a model: the kernel's
    output within 1e-4 (absolute, as ``flash_lm_shapes``); with ``d_out``
    also the backward kernels' dq, dk and dv (on the whole call) within
    ``FLASH_BWD_TOL`` x the largest of ``attention_bshd_bwd_ref``'s on the
    slice."""
    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.flash import ref as fref

    b, _, h, _ = q.shape
    g = h // k.shape[2]
    n_kv = max(1, n_heads // g)
    n_h = n_kv * g
    sl = (q[:, :, :n_h], k[:, :, :n_kv], v[:, :, :n_kv])
    got, lse = fops._bshd_fwd(q, k, v, **kw, with_lse=True)
    want = fref.attention_bshd_ref(*sl, **kw)
    res = dict(heads=f"{n_h} of {h}",
               out_max_abs_err=float((got[:, :, :n_h] - want).abs().max()))
    check(res["out_max_abs_err"] <= 1e-4, f"attention over {n_h} heads "
          f"within 1e-4 of the plain version ({res['out_max_abs_err']})")
    if d_out is not None:
        bkw = {x: kw[x] for x in ("causal", "window", "softcap", "kv_len",
                                  "scale")}
        grads = fops.attention_bshd_bwd(q, k, v, got, lse, d_out, **bkw)
        plain = fref.attention_bshd_bwd_ref(
            *sl, got[:, :, :n_h], _head_slice(lse, n_h, b, h),
            d_out[:, :, :n_h], **bkw)
        for name, a, w in zip(("dq", "dk", "dv"),
                              (grads[0][:, :, :n_h], grads[1][:, :, :n_kv],
                               grads[2][:, :, :n_kv]), plain):
            err, top = float((a - w).abs().max()), float(w.abs().max())
            res[f"{name}_max_abs_err"], res[f"{name}_largest"] = err, top
            check(err <= FLASH_BWD_TOL * top, f"{name} over {n_h} heads "
                  f"within {FLASH_BWD_TOL} x {top} of the plain backward "
                  f"({err})")
    return res


# [lm-train]: (arch, cut (``cut_config``), batch, seq), published widths,
# float32 from seed 0, Adam at LM_TRAIN_LR on token_stream through the
# Prefetcher; 1 warm-up step, LM_TRAIN_TIMED timed steps and one profiled.
# granite-3-2b at full depth is the slice's main path (10.1 GB of
# parameters, 40.5 GB with gradients and Adam's moments). olmoe-1b-7b: 4 of
# its 16 layers (the MoE backward); gemma2-27b: 1 of its 23 (local, global)
# pairs at 5,120 tokens, past the 4,096 window (the softcap in the
# backward); deepseek-v2-236b: its segment 0, the dense MLA layer (Dv < D in
# the backward), since one MoE layer in float32 with Adam's moments is
# 3.77 B x 16 B = 60 GB
LM_TRAIN_RUNS = (("granite-3-2b", None, 4, 2048),
                 ("olmoe-1b-7b", 4, 4, 2048),
                 ("gemma2-27b", 1, 1, 5120),
                 ("deepseek-v2-236b", "seg0", 4, 2048))
LM_TRAIN_LR = 1e-3
LM_TRAIN_TIMED = 5
LM_TRAIN_LOSS_RTOL = 1e-5
LM_TRAIN_LEAF_TOL = 1e-3
# The training loss over a few steps of fresh token_stream batches is no
# gate: granite-3-2b at Adam 1e-3 (the reference's default) rises from
# 11.21 over its first 12 steps, and at 3e-4 and 1e-4 stays within 0.04 of
# it over 8 (``python -m repro_torch.launch.train --arch granite-3-2b
# --steps 12 --batch 4 --seq 2048 --lr ...`` on an H100), and the reference
# itself promises a drop after a few hundred steps
# (``repro/data/pipeline.py:67``). What is gated instead: a plain SGD step
# of LM_TRAIN_DESCENT x loss / |g|^2 along step 1's gradient (the kernels')
# lowers that batch's loss by at least half the first-order prediction
LM_TRAIN_DESCENT = 1e-3
LM_TRAIN_HEADS = 16         # heads of a per-call check against plain


def lm_train_phase(all_kernels: dict) -> dict:
    """Each model of ``LM_TRAIN_RUNS`` trained through ``make_train_step``
    and freed before the next. Gates: step 1's loss and gradient with the
    kernels against the same step with ``attention_bshd_ref``'s autograd in
    their place (at batch 1 where the plain score blocks pass
    ``PLAIN_SCORES_GB``; the MoE's routing carried across,
    ``carried_routes``) within ``LM_TRAIN_LOSS_RTOL`` and, leaf by leaf,
    ``LM_TRAIN_LEAF_TOL`` x the leaf's largest magnitude; a small SGD step
    along that gradient lowers the loss (``LM_TRAIN_DESCENT``); launches
    exact in every step (flash_fwd twice per layer, forward and recompute;
    each backward kernel once; nothing else); finite losses (printed, not
    held to fall over six steps). deepseek-v2's MLA call also forward and
    backward over ``LM_TRAIN_HEADS`` heads at the full batch
    (``head_slice_check``). Prints step ms (host clock ending in
    ``float(loss)``, median of the timed steps), tokens/s, peak GB and one
    profiled step's device ms by group."""
    from repro_torch import configs
    from repro_torch.data.pipeline import Prefetcher, token_stream
    from repro_torch.dist.runtime import resolve_device
    from repro_torch.kernels.flash import ref as fref
    from repro_torch.models.lm import model as LM
    from repro_torch.train import optimizer as optlib

    dev = resolve_device()
    out = {}
    t_phase = time.perf_counter()

    def counts():
        return {name: meta["k"].launches for name, meta in all_kernels.items()}

    def zero():
        for meta in all_kernels.values():
            meta["k"].launches = 0

    for arch, cut, b, s in LM_TRAIN_RUNS:
        t_run = time.perf_counter()
        cfg = cut_config(configs.get(arch).config(), cut)
        n = cfg.n_layers
        want_launches = {name: 0 for name in all_kernels}
        want_launches.update(flash_fwd=2 * n, flash_bwd_dq=n,
                             flash_bwd_dkdv=n)
        heads = max(lc.attn.n_heads for _, _, lc, _ in cfg.sub_layers())
        params = LM.init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                dtype=torch.float32)
        n_alloc = sum(t.numel() for _, t in LM.tree_leaves(params))
        log(f"[lm-train] {arch}: {n} layers ({[sg.count for sg in cfg.segments]}"
            f" per segment), d_model {cfg.d_model}, {cfg.param_count()} "
            f"parameters ({n_alloc} allocated), float32 "
            f"{n_alloc * 4 / 1e9:.2f} GB, x4 with gradients and Adam's "
            f"moments; batch {b} x {s}, Adam {LM_TRAIN_LR}")
        stream = Prefetcher(token_stream(cfg.vocab, b, s, SEED,
                                         n_batches=LM_TRAIN_TIMED + 2),
                            device=dev)
        batches = list(stream)
        run = dict(layers=n, params=cfg.param_count(), batch=b, seq=s,
                   cut=cut)

        # step 1 with the kernels and with the plain attention
        bc = b if b * heads * s * min(1024, s) * 4 / 1e9 <= PLAIN_SCORES_GB \
            else 1
        tok, lab = (x[:bc] for x in batches[0])
        routes, moved = [], []
        zero()
        with carried_routes(routes, False, moved):
            loss_k, grads_k = LM.loss_and_grads(params, tok, lab, cfg)
        torch.cuda.synchronize()
        got = counts()
        check(got == want_launches, f"[lm-train] {arch}: step 1's gradient "
              f"launched {got}, expected {want_launches}")
        real_attn = LM.attention_bshd
        LM.attention_bshd = fref.attention_bshd_ref
        try:
            with carried_routes(routes, True, moved):
                loss_p, grads_p = LM.loss_and_grads(params, tok, lab, cfg)
        finally:
            LM.attention_bshd = real_attn
        rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        worst = ("", 0.0)
        for path, gk in LM.tree_leaves(grads_k):
            gp = grads_p
            for key in path:
                gp = gp[key]
            top = float(gp.abs().max())
            ratio = float((gk - gp).abs().max()) / max(top, 1e-30)
            if ratio >= worst[1]:
                worst = ("/".join(path), ratio)
        del grads_p
        # a small step along the kernels' gradient lowers the loss (Armijo):
        # predicted drop LM_TRAIN_DESCENT x the loss
        gsq = sum(float(gk.double().square().sum())
                  for _, gk in LM.tree_leaves(grads_k))
        eta = LM_TRAIN_DESCENT * float(loss_k) / gsq
        stepped = optlib.tree_map(lambda p_, g_: p_ - eta * g_, params,
                                  grads_k)
        del grads_k
        with torch.no_grad():
            loss_s = float(LM.lm_loss(stepped, tok, lab, cfg))
        del stepped
        descent = dict(sgd_lr=eta, predicted_drop=eta * gsq,
                       drop=float(loss_k) - loss_s)
        check(descent["drop"] >= 0.5 * descent["predicted_drop"],
              f"[lm-train] {arch}: a step of {eta:.3g} along the kernels' "
              f"gradient lowers the loss by at least half the first-order "
              f"prediction ({descent})")
        run["plain_step1"] = dict(
            batch=bc, loss_kernels=float(loss_k), loss_plain=float(loss_p),
            loss_rel_err=rel, worst_leaf=worst[0],
            worst_leaf_err_over_largest=worst[1],
            moe_assignments_moved=sum(moved) if routes else None,
            moe_assignments=sum(r.numel() for r in routes) if routes
            else None, descent=descent)
        log(f"[lm-train] {arch}: step 1 against plain attention at batch "
            f"{bc}: {json.dumps(run['plain_step1'])}")
        check(rel <= LM_TRAIN_LOSS_RTOL and worst[1] <= LM_TRAIN_LEAF_TOL,
              f"[lm-train] {arch}: step 1 with the kernels within "
              f"{LM_TRAIN_LOSS_RTOL} (loss, {rel}) and {LM_TRAIN_LEAF_TOL} x "
              f"each leaf's largest (worst {worst}) of the plain attention's")
        del routes
        torch.cuda.empty_cache()

        if any(lc.attn.kind == "mla" for _, _, lc, _ in cfg.sub_layers()):
            calls = []
            with recording(LM, "attention_bshd", calls), torch.no_grad():
                LM.forward(params, batches[0][0], cfg)
            q, k, v = calls[0][:3]
            kw = dict(zip(("causal", "window", "softcap", "q_offset",
                           "kv_len", "block", "scale"), calls[0][3:]))
            del calls
            d_out = torch.randn(q.shape[:3] + v.shape[-1:], device=dev,
                                generator=torch.Generator(dev)
                                .manual_seed(SEED))
            run["mla_call"] = head_slice_check(q, k, v, kw, LM_TRAIN_HEADS,
                                               d_out)
            log(f"[lm-train] {arch}: the MLA call {tuple(q.shape)} / "
                f"{tuple(v.shape)} over {run['mla_call']['heads']} heads, "
                f"forward and backward: {json.dumps(run['mla_call'])}")
            del q, k, v, d_out
            torch.cuda.empty_cache()

        # the training steps
        opt = optlib.adam(LM_TRAIN_LR)
        state = (params, opt.init(params),
                 torch.zeros((), dtype=torch.int32, device=dev))
        step_fn = LM.make_train_step(cfg, opt)
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i, (tok, lab) in enumerate(batches[:LM_TRAIN_TIMED + 1]):
            zero()
            t0 = time.perf_counter()
            state, loss = step_fn(state, tok, lab)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
            got = counts()
            check(got == want_launches, f"[lm-train] {arch}: step {i + 1} "
                  f"launched {got}, expected {want_launches}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(all(np.isfinite(losses)), f"[lm-train] {arch}: losses finite "
              f"({losses})")
        (state, _), *prof = profile_device(
            lambda: step_fn(state, *batches[-1]),
            f"{arch}: one training step (batch {b} x {s})")
        step_ms = float(np.median(ms[1:]))
        run.update(
            losses=losses, step_ms=ms, median_step_ms=step_ms,
            tokens_per_s=b * s / step_ms * 1e3, peak_gb=peak,
            step1_equals_gradient_run=bc == b and losses[0] == float(loss_k),
            launches=dict(want_launches),
            profile=dict(host_ms=prof[0], device_busy_ms=prof[1],
                         flash_fwd_ms=prof[2]["flash"],
                         flash_bwd_ms=prof[2]["flash_bwd"],
                         cublas_ms=prof[2]["gemm"],
                         rest_ms=prof[1] - prof[2]["flash"]
                         - prof[2]["flash_bwd"] - prof[2]["gemm"]),
            seconds=time.perf_counter() - t_run)
        log(f"[lm-train] {arch}: {json.dumps(run)}")
        out[arch] = run
        del params, state, batches, stream, step_fn, opt, tok, lab, loss
        torch.cuda.empty_cache()
    log(f"[lm-train] {len(out)} models in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


def train_phase(all_kernels: dict) -> dict:
    """GCN 256x2, GraphSAGE 256x2 and GAT 4x64 (the paper configs of the
    port's registry) trained full-graph on reddit_like@paper, P=4: vanilla,
    Sylvie-S and Sylvie-A, ``TRAIN_EPOCHS`` epochs each. Kernel counts are
    zeroed before each epoch and read after it; they must equal
    ``TRAIN_LAUNCHES``. Returns the launches per step, GCN's and GAT's last
    Sylvie-S step's kernel inputs (recorded) and their blocks."""
    from repro_torch import configs, datasets
    from repro_torch.core import exchange as X
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.models.gnn import blocks as B
    from repro_torch.policy import BoundedStaleness, Uniform
    from repro_torch.train.trainer import GNNTrainer

    pg, _ = datasets.load_partitioned("reddit_like@paper", n_parts=4)
    d_in, n_cls = pg.x.shape[-1], pg.n_classes
    runs = {"vanilla": (SylvieConfig(mode="vanilla"), None),
            "sylvie_s": (SylvieConfig(mode="sync", bits=1), Uniform(bits=1)),
            "sylvie_a": (SylvieConfig(mode="async", bits=1),
                         BoundedStaleness(eps_s=4, bits=1))}
    out = dict(launches={})
    for arch in TRAIN_ARCHS:
        for name, (cfg, pol) in runs.items():
            torch.manual_seed(SEED)
            model = configs.get(arch).config().make(d_in, n_cls)
            tr = GNNTrainer(model, pg, cfg, policy=pol, seed=SEED)
            torch.cuda.reset_peak_memory_stats()
            hist = []
            for _ in range(TRAIN_EPOCHS):
                for meta in all_kernels.values():
                    meta["k"].launches = 0
                m = tr.train_epoch()                 # ends in float(loss)
                got = tuple(all_kernels[k]["k"].launches
                            for k in TRAIN_KERNELS)
                want = TRAIN_LAUNCHES[(arch, name, m.mode)]
                check(got == want
                      and all_kernels["flash_fwd"]["k"].launches == 0,
                      f"[train] {arch} {name} {m.mode} epoch {m.epoch}: "
                      f"launches {dict(zip(TRAIN_KERNELS, got))}, expected "
                      f"{dict(zip(TRAIN_KERNELS, want))} and no flash")
                out["launches"][f"{arch}_train_{name}_{m.mode}_step"] = {
                    k: meta["k"].launches for k, meta in all_kernels.items()}
                hist.append(m)
            peak = torch.cuda.max_memory_allocated()
            acc = tr.evaluate("val")
            losses = [m.loss for m in hist]
            tag = f"{arch} {name}"
            check(all(np.isfinite(losses)), f"[train] {tag}: losses finite")
            # GAT at 1 bit does not train at these widths in the reference
            # either (GAT_ONE_BIT): its losses are only required finite
            check(losses[-1] < losses[0] or (arch, name) in GAT_ONE_BIT,
                  f"[train] {tag}: last loss {losses[-1]} below the first "
                  f"{losses[0]}")
            ms = {mode: sorted(m.seconds * 1e3 for m in hist[1:]
                               if m.mode == mode) for mode in ("sync",
                                                               "async")}
            med = {mode: v[len(v) // 2] if v else None
                   for mode, v in ms.items()}
            res = out[f"{arch}_{name}"] = dict(
                median_epoch_ms=med, n_epochs=TRAIN_EPOCHS,
                loss_first=losses[0], loss_last=losses[-1],
                loss_min=min(losses), val_acc=acc,
                payload_mb=hist[-1].comm_payload_mb,
                ec_mb=hist[-1].comm_ec_mb, peak_gb=peak / 1e9,
                modes="".join(m.mode[0] for m in hist))
            log(f"[train] {tag} ({tr.policy.name}): {json.dumps(res)}")
            if name == "sylvie_a" and arch != "graphsage":
                for mode in ("sync", "async"):      # epochs 20 (sync), 21
                    *_, by_kernel = profile_device(
                        tr.train_epoch, f"one {mode} epoch of {arch} "
                        f"Sylvie-A (epoch {tr.epoch})")
                    # the backward reads alpha through perm_t: no gather
                    gathers = {k: n for k, n in by_kernel.items()
                               if "vectorized_gather_kernel" in k}
                    check(arch != "gat" or not gathers,
                          f"[train] a {mode} GAT epoch launched index "
                          f"gathers: {gathers}")
            if name == "sylvie_s" and arch == "gcn":
                # one more step with its backward tensors recorded
                rec = dict(aggregate=[], scatter=[], quantize=[])
                with recording(B, "spmm", rec["aggregate"]), \
                        recording(X, "spmm", rec["scatter"]), \
                        recording(sys.modules[
                            "repro_torch.kernels.quant.ops"],
                            "quantize_pack_rows", rec["quantize"]):
                    tr.train_epoch()
                out["recorded"], out["block"] = rec, tr.block
            if name == "sylvie_s" and arch == "gat":
                # one more step with every GAT kernel's inputs recorded
                rec = {k: [] for k in ("spmm_heads", "softmax", "sddmm_heads",
                                       "softmax_bwd", "row_sums_t")}
                with recording(B, "spmm_heads", rec["spmm_heads"]), \
                        recording(gops, "softmax", rec["softmax"]), \
                        recording(gops, "sddmm_heads", rec["sddmm_heads"]), \
                        recording(gops, "softmax_bwd", rec["softmax_bwd"]), \
                        recording(gops, "row_sums_t", rec["row_sums_t"]):
                    tr.train_epoch()
                out["gat_recorded"], out["gat_block"] = rec, tr.block
            del tr, model
            torch.cuda.empty_cache()
    log(f"[train] kernel launches per step: {json.dumps(out['launches'])}")
    out["pg"] = pg              # [analysis] censuses an epoch on it
    return out


def train_kernels_phase(rec: dict, block) -> dict:
    """The SpMM over the transposed CSR, the scatter CSR and the Low-bit
    Module on the site-1 gradient, on the tensors one Sylvie-S step gave
    them, each bit-equal to its plain version run on the card."""
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref

    res = dict(spmm_csr=0.0, quantize_pack=0.0, unpack_dequantize=0.0)
    csr_t, scatter = block.csr_t, block.plan.scatter
    back = [a for a in rec["aggregate"] if a[1] is csr_t]
    check(len(back) == 1 and back[0][0].shape[1] == 256,
          "one transposed SpMM at d = 256 in a sync step")
    for tag, (g, csr) in (("transposed CSR", back[0]),
                          ("scatter CSR", rec["scatter"][0])):
        check(csr is (csr_t if tag == "transposed CSR" else scatter),
              f"{tag}: the step's own CSR")
        out_k, out_r = sops.spmm(g, csr), sref.spmm_ref(g, csr)
        err = float((out_k - out_r).abs().max())
        check(same_bits(out_k, out_r), f"[train-kernels] spmm over the {tag}"
              f": bit-equal to the plain version (max abs err {err})")
        check(same_bits(out_k, sops.spmm(g, csr)),
              f"[train-kernels] spmm over the {tag}: same bits twice")
        res["spmm_csr"] = max(res["spmm_csr"], err)
        log(f"[train-kernels] spmm over the {tag} {tuple(g.shape)} -> "
            f"{tuple(out_k.shape)}, nnz {csr.nnz}, {csr.long_rows.numel()} "
            f"split rows: bit-equal to the plain version, twice")
    g, csr = back[0]
    with warnings.catch_warnings():       # sparse CSR is "beta" in PyTorch
        warnings.simplefilter("ignore")
        sparse_t = torch.sparse_csr_tensor(csr.row_ptr, csr.col, csr.w,
                                           size=(csr.n_rows, csr.n_cols))
    d = g.shape[1]
    tb, to = bound(g.numel() * 4 + (csr.n_rows + 1) * 4 + csr.nnz * 8
                   + csr.n_rows * d * 4, 2 * csr.nnz * d)
    res.update(
        transposed_shape=[csr.n_rows, csr.n_cols, d, csr.nnz],
        transposed_ms=cuda_ms(lambda: sops.spmm(g, csr)),
        transposed_plain_ms=cuda_ms(lambda: sref.spmm_ref(g, csr), iters=2,
                                    warmup=1),
        transposed_library_ms=cuda_ms(lambda: torch.sparse.mm(sparse_t, g)),
        transposed_bound_ms=tb, transposed_bound_by=to,
        scatter_ms=cuda_ms(lambda: sops.spmm(*rec["scatter"][0])))
    check(len(rec["quantize"]) == 3, "three quantize calls in a Sylvie-S step")
    h = rec["quantize"][-1][0]               # the site-1 gradient buffer
    check(h.shape[1] == 256, "the backward quantizes the site-1 gradient")
    for bits in (1, 2, 4, 8):
        for stochastic in (False, True):
            u = torch.rand(h.shape, device=h.device, generator=torch.Generator(
                "cuda").manual_seed(bits)) if stochastic else None
            q_err, d_err = check_quant(qops, qref, h, u, bits,
                                       "site-1 gradient")
            res["quantize_pack"] = max(res["quantize_pack"], q_err)
            res["unpack_dequantize"] = max(res["unpack_dequantize"], d_err)
    log(f"[train-kernels] quantize/dequantize of the site-1 gradient "
        f"{tuple(h.shape)}: bits 1/2/4/8, stochastic and deterministic, f32 "
        f"and bf16 scale/zero, bit-equal to the plain versions")
    log(f"[train-kernels] {json.dumps(res)}")
    return res


# sddmm_heads at other shapes than the step's: (tag, heads, columns of the
# step's (n, 256) tables, offset view)
SDDMM_SHAPES = (("4 heads, dh 16", 4, 64, False),
                ("4 heads, dh 64, offset view", 4, 256, True),
                ("4 heads, dh 63", 4, 252, False),
                ("1 head, dh 256", 1, 256, False),
                ("2 heads, dh 128", 2, 256, False),
                ("8 heads, dh 32", 8, 256, False))


def sddmm_shapes(g: torch.Tensor, table: torch.Tensor, csr) -> dict:
    """sddmm_heads against its plain version, bit for bit and the same bits
    on a second run, at ``SDDMM_SHAPES`` over the step's CSR: the first
    columns of its g and table, or a copy starting one float into its
    buffer (not 16-byte aligned: the 4-byte copies). Returns ms by tag."""
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.kernels.gat import ref as gref

    out = {}
    for tag, heads, width, offset in SDDMM_SHAPES:
        gg, tt = (x[:, :width].contiguous() for x in (g, table))
        if offset:
            gg, tt = shifted(gg), shifted(tt)
        got, again = (gops.sddmm_heads(gg, tt, csr, heads) for _ in "ab")
        want = gref.sddmm_heads_ref(gg, tt, csr, heads)
        err = float((got - want).abs().max())
        check(same_bits(got, want) and same_bits(got, again),
              f"[gat-kernels] sddmm_heads at {tag}: bit-equal to the plain "
              f"version and twice (max abs err {err})")
        out[tag] = cuda_ms(lambda: gops.sddmm_heads(gg, tt, csr, heads))
    log(f"[gat-kernels] sddmm_heads bit-equal to its plain version, twice, "
        f"at {[t[0] for t in SDDMM_SHAPES]}; ms {json.dumps(out)}")
    return out


# gat_softmax and gat_softmax_bwd at rows harder than the step's: (tag, heads,
# offset views), each over one CSR of rows of GAT_ROW_LENGTHS edges (a row of
# 50,000 edges is 391 segments, one of 1,300 is 11) from GAT_ROW_SOURCES
# sources, columns drawn from SEED
GAT_ROW_LENGTHS = (50_000, 0, 1, 128, 129, 1_300, 33)
GAT_ROW_SOURCES = 10_000
GAT_ROW_SHAPES = (("1 head", 1, False), ("2 heads", 2, False),
                  ("4 heads", 4, False), ("8 heads", 8, False),
                  ("2 heads, offset views", 2, True),
                  ("4 heads, offset views", 4, True))


def _outputs(x) -> tuple:
    return (x,) if torch.is_tensor(x) else tuple(x)


def gat_row_shapes() -> dict:
    """gat_softmax (within rtol 1e-6, atol 1e-7) and gat_softmax_bwd in both
    modes (bit for bit) against their plain versions, and the same bits on a
    second run, at ``GAT_ROW_SHAPES``. Mode 1 sums over the same CSR, a
    random permutation of its edges standing for ``perm_t``. Offset views
    start one float into their buffers, so the kernels take their 4-byte
    loads. Returns {tag: {kernel: ms}}."""
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.kernels.gat import ref as gref
    from repro_torch.kernels.spmm.ref import csr_from_edges

    rng = np.random.default_rng(SEED)
    n_rows = len(GAT_ROW_LENGTHS)
    dst = np.repeat(np.arange(n_rows), GAT_ROW_LENGTHS)
    src = rng.integers(0, GAT_ROW_SOURCES, dst.size)
    csr = csr_from_edges(src, dst, np.ones(dst.size), n_rows,
                         GAT_ROW_SOURCES).to("cuda")
    perm = torch.from_numpy(rng.permutation(csr.nnz).astype(np.int32)).cuda()
    gen = torch.Generator("cuda").manual_seed(SEED)
    out = {}
    for tag, heads, offset in GAT_ROW_SHAPES:
        def rand(rows):
            t = torch.randn((rows, heads), device="cuda", generator=gen)
            return shifted(t) if offset else t
        s_src, s_dst, dalpha = (rand(n) for n in (GAT_ROW_SOURCES, n_rows,
                                                  csr.nnz))
        alpha = gops.softmax(s_src, s_dst, csr)
        dx = gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr)[0]
        if offset:
            alpha, dx = shifted(alpha), shifted(dx)
        cases = {
            "gat_softmax": (lambda: gops.softmax(s_src, s_dst, csr),
                            lambda: gref.gat_softmax_ref(s_src, s_dst, csr),
                            False),
            "gat_softmax_bwd": (
                lambda: gops.softmax_bwd(alpha, dalpha, s_src, s_dst, csr),
                lambda: gref.gat_softmax_bwd_ref(alpha, dalpha, s_src, s_dst,
                                                 csr), True),
            "gat_softmax_bwd_t": (lambda: gops.row_sums_t(dx, csr, perm),
                                  lambda: gref.row_sums_t_ref(dx, csr, perm),
                                  True)}
        out[tag] = {}
        for name, (kern, plain, exact) in cases.items():
            got, again, want = (_outputs(f()) for f in (kern, kern, plain))
            for a, b, w in zip(got, again, want):
                err = float((a - w).abs().max())
                check(same_bits(a, b), f"[gat-kernels] {name} at {tag}: "
                      f"same bits twice")
                check(same_bits(a, w) if exact else torch.allclose(
                    a, w, rtol=1e-6, atol=1e-7),
                      f"[gat-kernels] {name} at {tag}: against the plain "
                      f"version (max abs err {err})")
            out[tag][name] = cuda_ms(kern)
    log(f"[gat-kernels] gat_softmax (tol) and gat_softmax_bwd in both modes "
        f"(bit for bit) agree with their plain versions, twice, at "
        f"{[t[0] for t in GAT_ROW_SHAPES]} over rows of {GAT_ROW_LENGTHS} "
        f"edges; ms {json.dumps(out)}")
    return out


def gat_kernels_phase(rec: dict, block) -> dict:
    """GAT's four kernels on the inputs one Sylvie-S step of GAT 4x64 on
    reddit_like@paper gave them, each against its plain version run on the
    card: spmm_csr_heads (forward over the CSR; backward over the transposed
    CSR, reading alpha through ``w_idx = perm_t``, against the plain version
    over ``alpha[perm_t]`` and against the gather + kernel path that it
    replaced), sddmm_heads and gat_softmax_bwd (both modes) bit for bit (the
    same order, products and adds rounded apart); gat_softmax within rtol
    1e-6, atol 1e-7, because its ``expf`` and ``torch.exp`` need not round
    alike (whether it came out bit-equal is printed); spmm_csr_heads at one
    head bit-equal to spmm_csr; every kernel the same bits on a second run.
    sddmm_heads also bit for bit at other shapes (``SDDMM_SHAPES``: dh 16,
    an offset view that takes the 4-byte copies, dh 63, 1 / 2 / 8 heads),
    and the softmax and its backward at ``GAT_ROW_SHAPES``
    (``gat_row_shapes``). Then CUDA-event times beside the
    bytes-or-operations bound, the plain version and the library calls: for
    the per-head SpMM and the SDDMM one per head (``torch.sparse.mm``,
    ``torch.sparse.sampled_addmm``), for the softmax and its backward
    ``torch.sparse.softmax``, its backward and, for mode 1, ``index_add_``
    (``softmax_library_ms``); the replaced gather + kernel path and the
    gather alone beside the transposed per-head SpMM. A call of the softmax
    or its backward launches 2-3 kernels, its phases: their device times
    (``torch.profiler``), their sum and their count stand beside its event
    time, and the CUDA launches of a GAT step are printed beside
    ``TRAIN_LAUNCHES``' wrapper calls."""
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.kernels.gat import ref as gref
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref

    csr, csr_t, perm = block.csr, block.csr_t, block.perm_t
    rec = {k: [tuple(a.detach() if torch.is_tensor(a) else a for a in call)
               for call in calls] for k, calls in rec.items()}
    for k, n in (("spmm_heads", 4), ("softmax", 2), ("sddmm_heads", 2),
                 ("softmax_bwd", 2), ("row_sums_t", 2)):
        check(len(rec[k]) == n, f"[gat-kernels] {len(rec[k])} recorded "
              f"{k} calls in a GAT step, expected {n}")
    table, _, alpha, _ = rec["spmm_heads"][0]        # layer 0, forward
    g, csr_b, alpha_b, w_idx = rec["spmm_heads"][2]  # layer 1, backward
    check(csr_b is csr_t and table.shape[1] == 256 and alpha.shape[1] == 4,
          "[gat-kernels] the step's CSRs at width 256, 4 heads")
    # the backward reads the forward's alpha itself (the same storage)
    # through the block's own perm_t: no transposed copy
    check(w_idx.data_ptr() == perm.data_ptr() and alpha_b.data_ptr()
          == rec["spmm_heads"][1][2].data_ptr(),
          "[gat-kernels] the backward's per-head SpMM takes layer 1's alpha "
          "with w_idx = perm_t")
    alpha_t = torch.index_select(alpha_b, 0, perm)   # the replaced gather
    s_src, s_dst, _ = rec["softmax"][0]
    g_s, table_s, _, n_heads = rec["sddmm_heads"][0]
    a_b, da_b, ss_b, sd_b, _ = rec["softmax_bwd"][0]
    dx_b, _, _ = rec["row_sums_t"][0]
    nnz, h = csr.nnz, n_heads
    d = table.shape[1]
    rows, cols = csr.n_rows, csr.n_cols
    plan_bytes = (rows + 1) * 4 + nnz * 4
    cases = {
        "gat_softmax": (lambda: gops.softmax(s_src, s_dst, csr),
                        lambda: gref.gat_softmax_ref(s_src, s_dst, csr),
                        False, (cols + rows) * h * 4 + plan_bytes
                        + nnz * h * 4, 8 * nnz * h),
        "spmm_csr_heads": (lambda: sops.spmm_heads(table, csr, alpha),
                           lambda: sref.spmm_heads_ref(table, csr, alpha),
                           True, cols * d * 4 + plan_bytes + nnz * h * 4
                           + rows * d * 4, 2 * nnz * d),
        "spmm_csr_heads_t": (lambda: sops.spmm_heads(g, csr_t, alpha_b,
                                                     w_idx=perm),
                             lambda: sref.spmm_heads_ref(g, csr_t, alpha_t),
                             True, rows * d * 4 + (cols + 1) * 4 + nnz * 4
                             + nnz * h * 4 + nnz * 4 + cols * d * 4,
                             2 * nnz * d),
        "sddmm_heads": (lambda: gops.sddmm_heads(g_s, table_s, csr, h),
                        lambda: gref.sddmm_heads_ref(g_s, table_s, csr, h),
                        True, (rows + cols) * d * 4 + plan_bytes
                        + nnz * h * 4, 2 * nnz * d),
        "gat_softmax_bwd": (
            lambda: gops.softmax_bwd(a_b, da_b, ss_b, sd_b, csr),
            lambda: gref.gat_softmax_bwd_ref(a_b, da_b, ss_b, sd_b, csr),
            True, 3 * nnz * h * 4 + (cols + 2 * rows) * h * 4 + plan_bytes,
            7 * nnz * h),
        "gat_softmax_bwd_t": (
            lambda: gops.row_sums_t(dx_b, csr_t, perm),
            lambda: gref.row_sums_t_ref(dx_b, csr_t, perm),
            True, nnz * h * 4 + nnz * 4 + (cols + 1) * 4 + nnz * 4
            + cols * h * 4, nnz * h),
    }
    res = {}
    for name, (kern, plain, exact, n_bytes, n_ops) in cases.items():
        got, again, want = (_outputs(f()) for f in (kern, kern, plain))
        err, bit_equal = 0.0, True
        for a, b, w in zip(got, again, want):
            err = max(err, float((a - w).abs().max()))
            bit_equal = bit_equal and same_bits(a, w)
            check(same_bits(a, b), f"[gat-kernels] {name}: same bits twice")
            check(bit_equal if exact else torch.allclose(a, w, rtol=1e-6,
                                                         atol=1e-7),
                  f"[gat-kernels] {name}: against the plain version (max "
                  f"abs err {err}, {'bit for bit' if exact else 'tol'})")
        tb, to = bound(n_bytes, n_ops)
        res[name] = dict(max_abs_err=err, bit_equal=bit_equal,
                         ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=2,
                                                            warmup=1),
                         bound_ms=tb, bound_by=to, library_ms=None,
                         shape=[rows, cols, d, nnz, h])
        if name.startswith("gat_softmax"):
            # a call runs its phases as separate kernels, one launch each:
            # their device times (torch.profiler) and their sum, the call's
            # device time, with no host time or gap between launches in it
            t = name.endswith("_t")     # the row sums: one phase less
            hubs = (csr_t if t else csr).long_rows.numel() > 0
            try:
                ph = kernel_times(kern, expect=1 + hubs * (1 if t else 2))
            except RuntimeError as err:
                # the profiler held none of them in three traces (ROADMAP
                # §C): the phases go unmeasured, as device_ms' fall back
                log(f"[gat-kernels] {name}: {err}; phases not measured")
                ph = None
            res[name]["device_ms"] = ph and sum(v[0] for v in ph.values())
            res[name]["phases_ms"] = ph and {k: v[0] for k, v in ph.items()}
            res[name]["cuda_launches_per_call"] = ph and len(ph)
        if name.startswith(("spmm_csr_heads", "sddmm")):
            # the table rows they gather, a d-wide row per edge, and the
            # rate at which they gather them
            res[name]["gathered_gb"] = nnz * d * 4 / 1e9
            res[name]["gather_tb_s"] = nnz * d * 4 / res[name]["ms"] / 1e9
        log(f"[gat-kernels] {name}: {json.dumps(res[name])}")
    # the path the backward took before w_idx: gather alpha into the
    # transposed order, then the kernel; and the gather alone (the yardstick)
    gather_path = lambda: sops.spmm_heads(
        g, csr_t, torch.index_select(alpha_b, 0, perm))
    check(same_bits(sops.spmm_heads(g, csr_t, alpha_b, w_idx=perm),
                    gather_path()),
          "[gat-kernels] spmm_csr_heads over csr_t with w_idx = perm_t == "
          "the gather + kernel path, bit for bit")
    res["spmm_csr_heads_t"]["gather_path_ms"] = cuda_ms(gather_path)
    res["alpha_t_gather"] = dict(
        ms=cuda_ms(lambda: torch.index_select(alpha_b, 0, perm)),
        indexing_ms=cuda_ms(lambda: alpha_b[perm]),
        bound_ms=bound(2 * nnz * h * 4 + nnz * 4, 0)[0])
    t = res["spmm_csr_heads_t"]
    log(f"[gat-kernels] spmm_csr_heads over csr_t: {t['ms']:.4f} ms with "
        f"w_idx, {t['gather_path_ms']:.4f} ms gather + kernel (bit-equal); "
        f"alpha[perm_t] alone: {json.dumps(res['alpha_t_gather'])}")
    res["sddmm_heads"]["shapes"] = sddmm_shapes(g_s, table_s, csr)
    rows_ms = gat_row_shapes()
    for name in ("gat_softmax", "gat_softmax_bwd", "gat_softmax_bwd_t"):
        res[name]["shapes"] = {tag: ms[name] for tag, ms in rows_ms.items()}
    lib = softmax_library_ms(
        csr, s_src, s_dst, gops.softmax(s_src, s_dst, csr), a_b, da_b, ss_b,
        sd_b, dx_b, gops.row_sums_t(dx_b, csr_t, perm))
    for name, call in (("gat_softmax", "softmax"),
                       ("gat_softmax_bwd", "softmax_bwd"),
                       ("gat_softmax_bwd_t", "row_sums_t")):
        res[name]["library_ms"] = lib[call]["ms"]
    log(f"[gat-kernels] library: torch.sparse.softmax, its backward "
        f"(aten._sparse_softmax_backward_data), index_add_ over the CSR's "
        f"columns (mode 1): {json.dumps(lib)}")
    # TRAIN_LAUNCHES counts wrapper calls; each call of the softmax and its
    # backward launches its phases
    per_call = {n: res[n]["cuda_launches_per_call"] for n in (
        "gat_softmax", "gat_softmax_bwd", "gat_softmax_bwd_t")}
    calls = {"gat_softmax": len(rec["softmax"]),
             "gat_softmax_bwd": len(rec["softmax_bwd"]),
             "gat_softmax_bwd_t": len(rec["row_sums_t"])}
    launched = None if None in per_call.values() else sum(
        per_call[n] * calls[n] for n in calls)
    log(f"[gat-kernels] CUDA launches per wrapper call {per_call}; a GAT "
        f"step's wrapper calls {calls} (TRAIN_LAUNCHES: gat_softmax 2, "
        f"gat_softmax_bwd 4 = both modes) launch {launched} CUDA kernels")
    one = alpha[:, :1].contiguous()
    check(same_bits(sops.spmm_heads(table, csr, one), sops.spmm(
        table, dataclasses.replace(csr, w=alpha[:, 0].contiguous()))),
        "[gat-kernels] spmm_csr_heads at one head == spmm_csr, bit for bit")
    log("[gat-kernels] spmm_csr_heads at one head: bit-equal to spmm_csr")

    dh = d // h
    with warnings.catch_warnings():       # sparse CSR is "beta" in PyTorch
        warnings.simplefilter("ignore")
        a_heads = [torch.sparse_csr_tensor(
            csr.row_ptr, csr.col, alpha[:, k].contiguous(),
            size=(rows, cols)) for k in range(h)]
        t_heads = [table[:, k * dh:(k + 1) * dh].contiguous()
                   for k in range(h)]
        g_heads = [g_s[:, k * dh:(k + 1) * dh].contiguous()
                   for k in range(h)]
        ts_heads = [table_s[:, k * dh:(k + 1) * dh].t()
                    for k in range(h)]
        res["spmm_csr_heads"]["library_ms"] = cuda_ms(
            lambda: [torch.sparse.mm(a, t) for a, t in zip(a_heads, t_heads)])
        res["sddmm_heads"]["library_ms"] = cuda_ms(
            lambda: [torch.sparse.sampled_addmm(a, gh, th, beta=0.0)
                     for a, gh, th in zip(a_heads, g_heads, ts_heads)])
    log(f"[gat-kernels] library calls, one per head: spmm "
        f"{res['spmm_csr_heads']['library_ms']} ms, sampled_addmm "
        f"{res['sddmm_heads']['library_ms']} ms")
    return res


def halo_rows_apart(a: torch.Tensor, b: torch.Tensor, atol_frac: float) -> int:
    """Rows of two (P, rows, d) halo buffers that are not allclose at rtol
    1e-4 and atol ``atol_frac`` times b's largest value."""
    a, b = a.cpu(), b.cpu()
    atol = atol_frac * float(b.abs().max())
    close = torch.isclose(a, b, rtol=1e-4, atol=atol).all(-1)
    return int((~close).sum())


def train_parity_phase() -> dict:
    """Deterministic 6-epoch Sylvie-S and Sylvie-A (eps_s=2) of GCN,
    GraphSAGE and GAT (reduced: d_hidden 16) on yelp_like@small from the
    same numpy weights, on the card and on the CPU (the plain versions the
    CPU tests hold to JAX): losses allclose at rtol 1e-4; halo caches and
    gradients allclose (rtol 1e-4; atol 1e-6 of the site's largest feature,
    1e-3 of its largest gradient: rows of gradient that are cancellation
    noise may take other 1-bit codes) but for at most 1% of the rows,
    counted — the products run in another order on the card, and a row's
    bf16 scale can round to its neighbour. GAT exchanges hw = h @ w at 1
    bit, so those differences flip codes and a free run drifts apart
    chaotically (as against JAX, ``tests/test_torch_train_sage_gat.py``):
    its card trainer takes the CPU trainer's state before every epoch, and
    a vanilla GAT run is compared free."""
    from repro_torch import configs, datasets
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.dist.runtime import Runtime
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.policy import BoundedStaleness, Uniform
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.trainer import GNNTrainer

    pg, _ = datasets.load_partitioned("yelp_like@small", n_parts=4)
    dims = (pg.x.shape[-1], pg.n_classes)
    res = {}
    for arch in TRAIN_ARCHS:
        spec = configs.get(arch).reduced()
        torch.manual_seed(SEED)
        params = params_to_numpy(spec.make(*dims))
        runs = [("sylvie_s", SylvieConfig(mode="sync", bits=1,
                                          stochastic=False),
                 Uniform(bits=1, stochastic=False)),
                ("sylvie_a", SylvieConfig(mode="async", bits=1,
                                          stochastic=False),
                 BoundedStaleness(eps_s=2, bits=1, stochastic=False))]
        if arch == "gat":
            runs.append(("vanilla", SylvieConfig(mode="vanilla"), None))
        for name, cfg, pol in runs:
            tr = {dev: GNNTrainer(spec.make(*dims), pg, cfg, policy=pol,
                                  params=params,
                                  runtime=Runtime.simulated(4, device=dev))
                  for dev in ("cuda", "cpu")}
            lockstep = arch == "gat" and name != "vanilla"
            for _ in range(6):
                if lockstep:
                    tr["cuda"].state = optlib.tree_map(
                        lambda t: t.to(tr["cuda"].device), tr["cpu"].state)
                for t in tr.values():
                    t.train_epoch()
            losses = {dev: [m.loss for m in t.history]
                      for dev, t in tr.items()}
            err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                            losses["cpu"]))
            tag = f"[train-parity] {arch} {name}"
            check(np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4,
                              atol=0),
                  f"{tag}: losses card vs CPU (max rel {err})")
            halo = {dev: t.state.halo for dev, t in tr.items()}
            n_rows = pg.plan.n_parts * tr["cpu"].block.plan.halo_rows
            apart = dict(
                feats=[halo_rows_apart(a, b, 1e-6) for a, b in zip(
                    halo["cuda"].feats, halo["cpu"].feats)],
                grads=[halo_rows_apart(a, b, 1e-3) for a, b in zip(
                    halo["cuda"].grads, halo["cpu"].grads)])
            check(max(apart["feats"] + apart["grads"]) <= 0.01 * n_rows,
                  f"{tag}: halo rows apart {apart} of {n_rows}")
            res[f"{arch}_{name}"] = dict(
                loss_max_rel=err, rows_apart=apart, rows=n_rows,
                lockstep=lockstep,
                modes="".join(m.mode[0] for m in tr["cpu"].history))
            log(f"{tag}: {json.dumps(res[f'{arch}_{name}'])}")
    return res


# seg_max_min and its backward also over rows of these lengths (0: an empty
# row; 129 and 1,300 are split into 128-edge segments), at these widths (1
# column; PNA's 75; two and four column chunks of 80), on messages drawn
# from a coarse grid, half their zeros -0, so that ties of +0 and -0 are
# common, with a NaN, and 10 padded message rows no edge reaches
SEG_ROW_LENGTHS = (0, 1, 128, 129, 1_300, 33)
SEG_WIDTHS = (1, 75, 130, 257)


def seg_inputs(msgs: torch.Tensor, csr, seed: int):
    """Gradients of ``seg_max_min``'s two (n_rows, d) results as PNA's
    ``cat`` hands them (column slices of one (n_rows, 4d) tensor), from
    ``seed``."""
    gen = torch.Generator(msgs.device).manual_seed(seed)
    d = msgs.shape[1]
    g = torch.randn((csr.n_rows, 4 * d), generator=gen, device=msgs.device)
    return g[:, d:2 * d], g[:, 2 * d:3 * d]


def seg_max_shapes(device) -> int:
    """``seg_max_min`` against ``seg_max_min_ref`` and ``seg_max_min_bwd``
    against ``seg_max_min_vjp_ref`` on the card, bit for bit, over
    ``SEG_ROW_LENGTHS`` x ``SEG_WIDTHS``; returns the cases checked."""
    from repro_torch.kernels.seg import ops as segops
    from repro_torch.kernels.seg import ref as segref
    from repro_torch.kernels.spmm.ref import csr_from_edges

    rng = np.random.default_rng(SEED)
    dst = np.repeat(np.arange(len(SEG_ROW_LENGTHS)), SEG_ROW_LENGTHS)
    n_msgs = dst.size + 10
    src = rng.permutation(n_msgs)[:dst.size]
    csr = csr_from_edges(src, dst, np.ones(dst.size, np.float32),
                         len(SEG_ROW_LENGTHS), n_msgs).to(device)
    named = np.zeros(n_msgs, bool)
    named[src] = True
    pad = torch.as_tensor(np.nonzero(~named)[0], dtype=torch.int32,
                          device=device)
    for d in SEG_WIDTHS:
        m = np.round(rng.normal(0, 1, (n_msgs, d)) * 2) / 2
        m[(m == 0) & (rng.random(m.shape) < 0.5)] = -0.0
        m[src[5], d // 2] = np.nan
        msgs = torch.as_tensor(m, dtype=torch.float32, device=device)
        outs = segops.seg_max_min(msgs, csr)
        tag = f"[zoo] seg_max_min at rows {SEG_ROW_LENGTHS}, d {d}"
        for a, b in zip(outs, segref.seg_max_min_ref(msgs, csr)):
            check(same_bits(a, b), f"{tag}: bit-equal to the plain version")
        g_max, g_min = seg_inputs(msgs, csr, d)
        got = segops.seg_max_min_bwd(msgs, csr, *outs, g_max, g_min, pad)
        check(same_bits(got, segref.seg_max_min_vjp_ref(
            msgs, csr, *outs, g_max, g_min, pad)),
              f"{tag}: the backward bit-equal to the plain version")
    return len(SEG_WIDTHS)


def seg_recorded(rec: list, rec_bwd: list, tag: str) -> dict:
    """``seg_max_min`` (``rec``: ``(msgs, csr)``) and ``seg_max_min_bwd``
    (``rec_bwd``: its arguments) on the tensors a recorded step gave them:
    bit-equal to their plain versions, ties included, and the same bits on
    a second call. Returns the largest errors by kernel, the tied outputs
    and the calls checked."""
    from repro_torch.kernels.seg import ops as segops
    from repro_torch.kernels.seg import ref as segref

    err, ties = 0.0, 0
    for i, (msgs, csr) in enumerate(rec):
        msgs = msgs.detach()
        got, want = segops.seg_max_min(msgs, csr), \
            segref.seg_max_min_ref(msgs, csr)
        err = max(err, float((got[0] - want[0]).abs().max()),
                  float((got[2] - want[2]).abs().max()))
        check(all(same_bits(a, b) for a, b in zip(got, want)),
              f"{tag} seg_max_min call {i}: bit-equal to the plain version")
        check(all(same_bits(a, b) for a, b in zip(
            got, segops.seg_max_min(msgs, csr))),
              f"{tag} seg_max_min call {i}: the same bits twice")
        ties += int((got[1] > 1).sum()) + int((got[3] > 1).sum())
    bwd_err = 0.0
    for i, args in enumerate(rec_bwd):
        got = segops.seg_max_min_bwd(*args)
        want = segref.seg_max_min_vjp_ref(*args)
        bwd_err = max(bwd_err, float((got - want).abs().max()))
        check(same_bits(got, want),
              f"{tag} seg_max_min_bwd call {i}: bit-equal to the plain "
              f"version")
        check(same_bits(got, segops.seg_max_min_bwd(*args)),
              f"{tag} seg_max_min_bwd call {i}: the same bits twice")
    return dict(seg_max_min_csr=err, seg_max_min_bwd_csr=bwd_err,
                tied_outputs=ties, seg_calls=len(rec),
                seg_bwd_calls=len(rec_bwd))


def seg_check(rec: list, rec_bwd: list) -> dict:
    """``seg_max_min`` and ``seg_max_min_bwd`` on the tensors one PNA
    Sylvie-S step gave them (max and min at each layer, forward and
    backward): bit-equal to their plain versions run on the card, ties
    included, and the same bits on a second run; also at
    ``seg_max_shapes``. The first layer's calls timed beside their bytes
    bounds and plain versions, the forward also beside ``scatter_reduce``
    (amax and amin, two calls; a yardstick only, the port never calls
    it)."""
    from repro_torch.kernels.seg import ops as segops
    from repro_torch.kernels.seg import ref as segref

    n_layers = _ZOO_STEP["pna"][0]
    check(len(rec) == n_layers and len(rec_bwd) == n_layers,
          f"[zoo] a PNA step called seg_max_min {len(rec)} and "
          f"seg_max_min_bwd {len(rec_bwd)} times")
    seg = seg_recorded(rec, rec_bwd, "[zoo]")
    err, bwd_err, ties = (seg["seg_max_min_csr"], seg["seg_max_min_bwd_csr"],
                          seg["tied_outputs"])
    msgs, csr = rec[0][0].detach(), rec[0][1]
    n_rows, d = csr.n_rows, msgs.shape[1]
    n_msgs, nnz = msgs.shape[0], csr.nnz
    # padded edges go to a row of their own, which the output leaves out
    idx = torch.full((n_msgs,), n_rows, dtype=torch.int64,
                     device=msgs.device)
    idx[csr.col.long()] = torch.repeat_interleave(
        torch.arange(n_rows, device=msgs.device),
        torch.diff(csr.row_ptr.long()))
    idx = idx[:, None].expand(-1, d)
    lib_max = torch.zeros((n_rows + 1, d), device=msgs.device)
    lib_min = torch.zeros((n_rows + 1, d), device=msgs.device)

    def library():
        lib_max.scatter_reduce_(0, idx, msgs, "amax", include_self=False)
        lib_min.scatter_reduce_(0, idx, msgs, "amin", include_self=False)
    plan_bytes = 4 * (nnz + csr.units.numel() + csr.long_rows.numel()
                      + csr.long_ptr.numel())
    # forward: the messages read once, four (n_rows, d) outputs written;
    # two compares per (edge, column)
    b, bo = bound(nnz * d * 4 + plan_bytes + n_rows * d * 16, 2 * nnz * d)
    # backward: the messages read and every gradient row written once, the
    # six per-row tensors and the padded rows' ids read once; two compares
    # and an add per (edge, column)
    args = rec_bwd[0]
    n_pad = args[-1].numel()
    bb, bbo = bound(nnz * d * 4 + n_msgs * d * 4 + plan_bytes + n_pad * 4
                    + 6 * n_rows * d * 4, 3 * nnz * d)
    res = dict(
        shape=[n_rows, n_msgs, d, nnz], max_abs_err=err,
        bwd_max_abs_err=bwd_err, bit_equal=True, calls_checked=len(rec),
        bwd_calls_checked=len(rec_bwd), tied_outputs=ties,
        row_shapes_checked=seg_max_shapes(msgs.device),
        split_rows=int(csr.long_rows.numel()),
        gathered_gb=nnz * d * 4 / 1e9,
        ms=cuda_ms(lambda: segops.seg_max_min(msgs, csr)),
        plain_ms=cuda_ms(lambda: segref.seg_max_min_ref(msgs, csr), iters=2,
                         warmup=1),
        library_ms=cuda_ms(library), library="scatter_reduce amax + amin",
        bound_ms=b, bound_by=bo,
        bwd_ms=cuda_ms(lambda: segops.seg_max_min_bwd(*args)),
        bwd_plain_ms=cuda_ms(lambda: segref.seg_max_min_vjp_ref(*args),
                             iters=2, warmup=1),
        bwd_bound_ms=bb, bwd_bound_by=bbo)
    res["bound_share"] = res["bound_ms"] / res["ms"]
    res["bwd_bound_share"] = res["bwd_bound_ms"] / res["bwd_ms"]
    log(f"[zoo] seg_max_min: {json.dumps(res)}")
    return res


def zoo_parity() -> dict:
    """The reduced zoo configs on their smoke graphs (``ZOO_SMOKE``), the
    same weights on both: 32-bit logits on the card against the CPU's plain
    versions, within rtol 1e-5 and atol ``ZOO_PARITY_ATOL``. A control runs
    the card's products in TF32 (cuBLAS's lower precision) and must fall
    outside that tolerance, so the gate can tell a float32 product from a
    lower-precision one."""
    from repro_torch import configs
    from repro_torch.core.sylvie import SylvieComm, SylvieConfig
    from repro_torch.launch.train import gnn_graph
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.gnn import blocks as B

    out = {}
    for arch, graph in ZOO_SMOKE.items():
        spec = configs.get(arch).reduced()
        spg = gnn_graph(spec, graph, 4, SEED)
        torch.manual_seed(SEED)
        params = params_to_numpy(spec.make(spg.x.shape[-1], spg.n_classes))
        logits = {}
        for dev, tf32 in (("cuda", False), ("cpu", False), ("cuda", True)):
            model = params_from_numpy(spec.make(spg.x.shape[-1],
                                                spg.n_classes), params, dev)
            block = B.build_block(spg, dev)
            comm = SylvieComm(SylvieConfig(mode="vanilla"), block.plan)
            was = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                with torch.no_grad():
                    logits[dev + "_tf32" * tf32] = model(
                        block, torch.as_tensor(spg.x, device=dev), comm).cpu()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = was
        want = logits["cpu"]
        err = {k: float((logits[k] - want).abs().max())
               for k in ("cuda", "cuda_tf32")}
        atol = ZOO_PARITY_ATOL
        check(torch.allclose(logits["cuda"], want, rtol=1e-5, atol=atol),
              f"[zoo] {arch} reduced on {graph}: 32-bit logits card vs CPU "
              f"(max abs err {err['cuda']})")
        check(not torch.allclose(logits["cuda_tf32"], want, rtol=1e-5,
                                 atol=atol),
              f"[zoo] {arch} reduced on {graph}: the TF32 control passes "
              f"the gate (max abs err {err['cuda_tf32']})")
        out[f"{arch}_parity_max_abs_err"] = err["cuda"]
        out[f"{arch}_parity_tf32_max_abs_err"] = err["cuda_tf32"]
        log(f"[zoo] {arch} reduced on {graph}: 32-bit logits card vs CPU, "
            f"max abs err {err['cuda']:.3g} (rtol 1e-5, atol {atol:g}); the "
            f"TF32 control {err['cuda_tf32']:.3g}, outside; largest |logit| "
            f"{float(want.abs().max()):.3g}")
    return out


def zoo_epoch(tr, all_kernels: dict, arch: str, run: str):
    """One epoch of the trainer ``tr`` (``run`` of ``arch``) with every
    count zeroed just before it and read just after it: exactly
    ``ZOO_LAUNCHES`` for its mode and no other kernel. Returns (its
    metrics, every kernel's count)."""
    for meta in all_kernels.values():
        meta["k"].launches = 0
    m = tr.train_epoch()                         # ends in float(loss)
    counts = {k: meta["k"].launches for k, meta in all_kernels.items()}
    got = tuple(counts[k] for k in ZOO_KERNELS)
    want = ZOO_LAUNCHES[(arch, run, m.mode)]
    others = {k: n for k, n in counts.items() if k not in ZOO_KERNELS and n}
    check(got == want and not others,
          f"[zoo] {arch} {run} {m.mode} epoch {m.epoch}: launches "
          f"{dict(zip(ZOO_KERNELS, got))}, expected "
          f"{dict(zip(ZOO_KERNELS, want))}, others {others}")
    return m, counts


def zoo_trainer(arch: str, pg, run: str):
    """``arch``'s full config on ``pg``, weights from ``SEED``, in a
    ``GNNTrainer`` for ``run``: vanilla, Sylvie-S (``Uniform(1)``) or
    Sylvie-A (``BoundedStaleness(eps_s=4)``, 1 bit), stochastic rounding,
    Adam at ``ZOO_ARCHS``' rate. Returns (trainer, model)."""
    from repro_torch import configs
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.policy import BoundedStaleness, Uniform
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.trainer import GNNTrainer

    cfg, pol = {
        "vanilla": (SylvieConfig(mode="vanilla"), None),
        "sylvie_s": (SylvieConfig(mode="sync", bits=1), Uniform(bits=1)),
        "sylvie_a": (SylvieConfig(mode="async", bits=1),
                     BoundedStaleness(eps_s=4, bits=1))}[run]
    torch.manual_seed(SEED)
    model = configs.get(arch).config().make(pg.x.shape[-1], pg.n_classes)
    return GNNTrainer(model, pg, cfg, opt=optlib.adam(ZOO_ARCHS[arch][1]),
                      policy=pol, seed=SEED), model


def zoo_profile(fn, arch: str, label: str):
    """:func:`profile_device` of ``fn``, with NequIP's tensor product marked
    (``nequip_tp``) when ``arch`` is NequIP. Returns (fn's result, host ms,
    device-busy ms, {group: ms}, {mark: range_ms})."""
    from repro_torch.models.gnn import nequip as NQ
    if arch != "nequip":
        return (*profile_device(fn, label)[:4], {})
    marks = {"nequip_tp": None}
    with marked(NQ, "tensor_product", "nequip_tp"):
        return (*profile_device(fn, label, marks)[:4], marks)


def recorded_kernels(rec: dict, tag: str) -> dict:
    """Every SpMM (``rec["aggregate"]`` and ``rec["scatter"]``: ``(table,
    csr)``) and every quantize call (``rec["quantize"]``: ``(h, u, bits,
    scale dtype)``) a recorded step made, on the tensors the step gave them:
    the SpMM bit-equal to its plain version run on the card and the same
    bits on a second call; quantize (the step's bits and noise) and
    dequantize of its result bit-equal to the plain versions, scale/zero in
    float32 and bfloat16 (:func:`check_quant`), the quantize the same bits
    twice. Returns the largest errors and the calls checked."""
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref

    res = dict(spmm_csr=0.0, quantize_pack=0.0, unpack_dequantize=0.0,
               spmm_calls=0, quantize_calls=len(rec["quantize"]))
    for g, csr in rec["aggregate"] + rec["scatter"]:
        g = g.detach()
        got, again = sops.spmm(g, csr), sops.spmm(g, csr)
        ref = sref.spmm_ref(g, csr)
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        check(same_bits(got, ref) and same_bits(got, again),
              f"{tag}: spmm {tuple(g.shape)} over {csr.n_rows} rows, nnz "
              f"{csr.nnz}: bit-equal to the plain version and twice (max "
              f"abs err {err})")
        res["spmm_csr"] = max(res["spmm_csr"], err)
        res["spmm_calls"] += 1
        del got, again, ref
    for h, u, bits, _ in rec["quantize"]:
        q_err, d_err = check_quant(qops, qref, h, u, bits,
                                   f"{tag} rows {tuple(h.shape)}")
        first, second = (qops.quantize_pack_rows(h, u, bits) for _ in "ab")
        check(all(same_bits(x, y) for x, y in zip(first, second)),
              f"{tag}: quantize {tuple(h.shape)} the same bits twice")
        res["quantize_pack"] = max(res["quantize_pack"], q_err)
        res["unpack_dequantize"] = max(res["unpack_dequantize"], d_err)
    check(res["spmm_calls"] > 0 and res["quantize_calls"] > 0,
          f"{tag}: no call recorded")
    return res


def zoo_wide_kernels(rec: dict, block, width: int, want: tuple) -> dict:
    """:func:`recorded_kernels` of one NequIP Sylvie-A sync step on
    ``ZOO_WIDE``'s graph: its SpMM over ``ecsr``, ``ecsr_t`` and the
    scatter CSR and its quantize calls, all ``width`` columns wide, as many
    as ``want`` (the step's ``ZOO_LAUNCHES``) says. Returns the largest
    errors and the calls checked by CSR."""
    tag = f"[zoo] {ZOO_WIDE[0]} on {ZOO_WIDE[1]}"
    csrs = {"ecsr": block.ecsr, "ecsr_t": block.ecsr_t,
            "scatter": block.plan.scatter}
    name = {id(c): k for k, c in csrs.items()}
    calls = rec["aggregate"] + rec["scatter"]
    check(len(calls) == want[2] and len(rec["quantize"]) == want[0],
          f"{tag}: {len(calls)} SpMM and {len(rec['quantize'])} quantize "
          f"calls recorded in a sync step, expected {want[2]} and {want[0]}")
    by_csr: dict = {}
    for g, csr in calls:
        what = name.get(id(csr))
        check(what is not None and g.shape[1] == width,
              f"{tag}: SpMM over {what} at d = {g.shape[1]}, expected one "
              f"of the step's CSRs at d = {width}")
        by_csr[what] = by_csr.get(what, 0) + 1
    for h, *_ in rec["quantize"]:
        check(h.shape[1] == width, f"{tag}: quantize at d = {h.shape[1]}, "
              f"expected {width}")
    res = dict(recorded_kernels(rec, tag), spmm_calls=by_csr)
    log(f"{tag}: the sync step's SpMM and Low-bit Module calls at d = "
        f"{width}, bit-equal to the plain versions and twice: "
        f"{json.dumps(res)}")
    return res


def zoo_wide(all_kernels: dict) -> dict:
    """NequIP's full config on ``ZOO_WIDE``'s graph under Sylvie-A
    (``zoo_trainer``): one warm sync epoch with its SpMM and quantize calls
    recorded and checked against the plain versions (``zoo_wide_kernels``),
    then one epoch profiled with the tensor product marked (``nequip_tp``),
    each launching exactly ``ZOO_LAUNCHES``; finite losses. Host and busy
    ms, the groups, the tensor product's device ms (forward and backward),
    and the profiled epoch's peak GB (the warm epoch's is raised by the
    tensors recorded)."""
    from repro_torch import configs
    from repro_torch.core import exchange as X
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.launch.train import gnn_graph
    from repro_torch.models.gnn import blocks as B

    arch, graph = ZOO_WIDE
    t0 = time.perf_counter()
    pg = gnn_graph(configs.get(arch).config(), graph, 4, SEED)
    n, e = int(pg.node_mask.sum()), int(pg.edge_mask.sum())
    tr, model = zoo_trainer(arch, pg, "sylvie_a")
    log(f"[zoo] {arch} on {graph}: {n} nodes, {e} edges, d_feat "
        f"{pg.x.shape[-1]}, {pg.n_classes} classes "
        f"({time.perf_counter() - t0:.1f} s to build)")
    launches = {}
    rec = dict(aggregate=[], scatter=[], quantize=[])
    with recording(B, "spmm", rec["aggregate"]), \
            recording(X, "spmm", rec["scatter"]), \
            recording(qops, "quantize_pack_rows", rec["quantize"]):
        m0, launches[f"{arch}_wide_sylvie_a_sync_step"] = zoo_epoch(
            tr, all_kernels, arch, "sylvie_a")
    check(m0.mode == "sync", f"[zoo] {arch} on {graph}: epoch 0 is sync")
    kernels = zoo_wide_kernels(rec, tr.block, model.width,
                               ZOO_LAUNCHES[(arch, "sylvie_a", "sync")])
    del rec
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (m1, counts), wall, busy, groups, marks = zoo_profile(
        lambda: zoo_epoch(tr, all_kernels, arch, "sylvie_a"), arch,
        f"the epoch after the warm one of {arch} Sylvie-A on {graph} "
        f"(epoch {tr.epoch})")
    launches[f"{arch}_wide_sylvie_a_{m1.mode}_step"] = counts
    peak = torch.cuda.max_memory_allocated()
    losses = [m0.loss, m1.loss]
    check(all(np.isfinite(losses)), f"[zoo] {arch} on {graph}: losses "
          f"{losses} finite")
    tp = marks["nequip_tp"]
    res = dict(graph=graph, nodes=n, edges=e, losses=losses,
               warm_sync_epoch_ms=m0.seconds * 1e3, profiled_mode=m1.mode,
               profiled_epoch_ms=m1.seconds * 1e3, host_ms=wall,
               busy_ms=busy, by_group=groups, nequip_tp=tp,
               nequip_tp_share_of_busy=tp["ms"] / busy if busy else None,
               payload_mb=m1.comm_payload_mb, peak_gb=peak / 1e9,
               kernels=kernels, launches=launches)
    log(f"[zoo] {arch} on {graph}: " + json.dumps(
        {k: v for k, v in res.items() if k not in ("launches", "kernels")}))
    del tr, model
    torch.cuda.empty_cache()
    return res


def zoo_phase(all_kernels: dict) -> dict:
    """PNA 4x75, MeshGraphNet 15x128, SchNet 3x64 and NequIP 5 x 32 (l <=
    2) (the registry's full configs) trained full-graph through
    ``launch.train.gnn_graph`` and ``GNNTrainer`` (``ZOO_ARCHS``,
    ``zoo_trainer``), P = 4, seed 0: ``ZOO_EPOCHS`` epochs each of vanilla,
    Sylvie-S and Sylvie-A. Counts are zeroed before each epoch and read
    after it: they must equal ``ZOO_LAUNCHES``, and no other kernel may
    launch. Vanilla losses fall; 1-bit losses are finite (whether they fall
    is printed). Then one Sylvie-A sync and async epoch of each profiled by
    kernel (``zoo_profile``), the seg kernels checked on one PNA Sylvie-S
    step's tensors (``seg_check``), NequIP on ``ZOO_WIDE``'s graph
    (``zoo_wide``), and the reduced configs' 32-bit logits on the smoke
    graphs, card against the CPU's plain versions (``zoo_parity``)."""
    from repro_torch import configs
    from repro_torch.launch.cells import _gnn_model_flops
    from repro_torch.launch.train import gnn_graph
    from repro_torch.models.gnn import blocks as B

    t_phase = time.perf_counter()
    out = dict(launches={})
    for arch, (graph, lr) in ZOO_ARCHS.items():
        t0 = time.perf_counter()
        pg = gnn_graph(configs.get(arch).config(), graph, 4, SEED)
        n, e = int(pg.node_mask.sum()), int(pg.edge_mask.sum())
        log(f"[zoo] {arch} on {graph}: {n} nodes, {e} edges, d_feat "
            f"{pg.x.shape[-1]}, {pg.n_classes} classes, edge attrs "
            f"{None if pg.edge_attr is None else pg.edge_attr.shape[-1]} "
            f"({time.perf_counter() - t0:.1f} s)")
        for name in ("vanilla", "sylvie_s", "sylvie_a"):
            tr, model = zoo_trainer(arch, pg, name)
            torch.cuda.reset_peak_memory_stats()
            hist = []
            for _ in range(ZOO_EPOCHS):
                m, counts = zoo_epoch(tr, all_kernels, arch, name)
                out["launches"][f"{arch}_train_{name}_{m.mode}_step"] = counts
                hist.append(m)
            peak = torch.cuda.max_memory_allocated()
            losses = [m.loss for m in hist]
            tag = f"{arch} {name}"
            check(all(np.isfinite(losses)), f"[zoo] {tag}: losses finite")
            check(name != "vanilla" or losses[-1] < losses[0],
                  f"[zoo] {tag}: last loss {losses[-1]} below the first "
                  f"{losses[0]}")
            ms = {mode: sorted(m.seconds * 1e3 for m in hist[1:]
                               if m.mode == mode) for mode in ("sync",
                                                               "async")}
            res = out[f"{arch}_{name}"] = dict(
                median_epoch_ms={mode: v[len(v) // 2] if v else None
                                 for mode, v in ms.items()},
                n_epochs=ZOO_EPOCHS, adam_lr=lr, losses=losses,
                falls=losses[-1] < losses[0], val_acc=tr.evaluate("val"),
                payload_mb=hist[-1].comm_payload_mb,
                ec_mb=hist[-1].comm_ec_mb, peak_gb=peak / 1e9,
                model_gflop_per_epoch=_gnn_model_flops(
                    arch, model, n, e, pg.x.shape[-1], True) / 1e9,
                modes="".join(m.mode[0] for m in hist))
            log(f"[zoo] {tag} ({tr.policy.name}): {json.dumps(res)}")
            if name == "sylvie_a":
                for mode in ("sync", "async"):
                    _, wall, busy, groups, marks = zoo_profile(
                        tr.train_epoch, arch, f"one {mode} epoch of {arch} "
                        f"Sylvie-A (epoch {tr.epoch})")
                    res[f"profile_{mode}"] = dict(host_ms=wall, busy_ms=busy,
                                                  by_group=groups, **marks)
            if name == "sylvie_s" and arch == "pna":
                rec: list = []
                rec_bwd: list = []
                with recording(B, "seg_max_min", rec), \
                        recording(B, "seg_max_min_bwd", rec_bwd):
                    tr.train_epoch()
                out["seg_max_min"] = seg_check(rec, rec_bwd)
                del rec, rec_bwd
            del tr, model
            torch.cuda.empty_cache()
    out["wide"] = zoo_wide(all_kernels)
    out["launches"].update(out["wide"].pop("launches"))
    out.update(zoo_parity())
    log(f"[zoo] kernel launches per step: {json.dumps(out['launches'])}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[zoo] phase done in {out['seconds']:.1f} s")
    return out


# the parent span each span of the serving front and the trainer must sit
# in (None: top level); a sweep outside a refresh is a full_sweep() call
SPAN_PARENTS = {"epoch": {None}, "decide": {"epoch"}, "step": {"epoch"},
                "admit": {None}, "request": {None}, "lookup": {"request"},
                "refresh": {None}, "plan": {"refresh"},
                "sweep": {"refresh", None}, "gather": {"refresh", None}}


def span_tree(events: list) -> dict:
    """Check every span's innermost enclosing span against ``SPAN_PARENTS``
    (a delta sweep must sit in a refresh); return {name: [count, median host
    ms]}."""
    spans = sorted((e for e in events if e["ph"] == "X"),
                   key=lambda e: (e["ts"], -e["dur"]))
    stack: list = []
    durs: dict = {}
    for e in spans:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
            stack.pop()
        parent = stack[-1]["name"] if stack and (
            e["ts"] + e["dur"] <= stack[-1]["ts"] + stack[-1]["dur"]) \
            else None
        allowed = SPAN_PARENTS.get(e["name"], set())
        if e["name"] == "sweep" and e.get("args", {}).get("kind") == "delta":
            allowed = {"refresh"}
        check(parent in allowed, f"[serve-front] span {e['name']} sits in "
              f"{parent}, expected one of {allowed}")
        durs.setdefault(e["name"], []).append(e["dur"] * 1e3)
        stack.append(e)
    return {k: [len(v), float(np.median(v))] for k, v in sorted(durs.items())}


def serve_front_phase(all_kernels: dict) -> dict:
    """The serving front through ``python -m repro_torch.launch.serve``'s
    ``serve_once`` at the paper's widths (see the module docstring)."""
    import tempfile

    from repro_torch import configs, obs
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.launch import serve as launch
    from repro_torch.policy import BoundedStaleness
    from repro_torch.serve import InferenceEngine
    from repro_torch.serve import loadgen
    from repro_torch.train.trainer import GNNTrainer

    names = list(all_kernels)

    def snap() -> np.ndarray:
        return np.array([all_kernels[k]["k"].launches for k in names])

    def zero() -> None:
        for meta in all_kernels.values():
            meta["k"].launches = 0

    def pinned(diff: np.ndarray) -> tuple:
        check(diff[names.index("flash_fwd")] == 0, "a sweep launched flash")
        return tuple(int(diff[names.index(k)]) for k in TRAIN_KERNELS)

    @contextlib.contextmanager
    def watching(sweeps: list):
        """Record each sweep (engine, kind, launches, report) of the
        engines built inside, by launch counts read around ``_run``."""
        real = InferenceEngine._run

        def run(self, *args, **kw):
            before = snap()
            rep = real(self, *args, **kw)
            sweeps.append((self, kw["kind"], pinned(snap() - before), rep))
            return rep
        InferenceEngine._run = run
        try:
            yield
        finally:
            InferenceEngine._run = real

    @contextlib.contextmanager
    def probing(loops: list):
        """Record each load generator run inside as (server, refreshes
        expected, refresh lags): the loop gets a clock that logs its reads
        (the loop reads it once at its start and once right after each
        refresh returns) and the server's refresh is wrapped to mark them."""
        real = {k: getattr(loadgen, k) for k in ("closed_loop", "open_loop")}

        def probed(name):
            def run(server, n_nodes, **kw):
                reads: list = []
                after: list = []        # index of the read after a refresh

                def clock() -> float:
                    reads.append(server.clock())
                    return reads[-1]

                def refresh(*args, **k):
                    rep = type(server).refresh(server, *args, **k)
                    after.append(len(reads))
                    return rep
                server.refresh = refresh
                try:
                    load = real[name](server, n_nodes, clock=clock, **kw)
                finally:
                    del server.refresh
                feed = sorted(kw.get("feed") or [], key=lambda b: b[0])
                every = kw.get("refresh_every")
                # the closed loop refreshes once per refresh_every
                # completions (its clients, fewer, finish at most that many
                # a step); the open loop once per feed batch (none is empty)
                want = len(feed) if name == "open_loop" else \
                    kw["requests"] // every if every else 0
                lags = [reads[i] - reads[0] - b[0]
                        for i, b in zip(after, feed)]
                loops.append((server, want, lags))
                return load
            return run
        for k in real:
            setattr(loadgen, k, probed(k))
        try:
            yield
        finally:
            for k, fn in real.items():
                setattr(loadgen, k, fn)

    def serve(*argv) -> tuple:
        """serve_once on the card with its counts zeroed just before and
        read just after: (report, sweeps, launches, seconds, refresh lags
        of the open loop's stream in s). Fails unless every refresh the load
        generator asked for ran and the server stayed healthy."""
        sweeps: list = []
        loops: list = []
        zero()
        t0 = time.perf_counter()
        with watching(sweeps), probing(loops):
            rep = launch.serve_once(launch.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        load = rep["load"]
        check(len(loops) == 1, f"[serve-front] {len(loops)} load runs")
        server, want, lags = loops[0]
        check(load["refresh_failures"] == 0 and server.refresh_failures == 0
              and server.health == "healthy",
              f"[serve-front] {argv}: {load['refresh_failures']} refreshes "
              f"failed, server {server.health}")
        check(load["refreshes"] == want, f"[serve-front] {argv}: "
              f"{load['refreshes']} refreshes, expected {want}")
        if "refresh_lag_max_s" in load:
            check(max(lags, default=0.0) == load["refresh_lag_max_s"]
                  and float(np.mean(lags) if lags else 0.0)
                  == load["refresh_lag_mean_s"],
                  f"[serve-front] refresh lags read back {lags} disagree "
                  f"with the report's max and mean")
        return rep, sweeps, snap(), secs, lags

    def same(a: np.ndarray, b: np.ndarray) -> bool:
        return a.shape == b.shape and a.dtype == b.dtype and \
            np.array_equal(a.view(np.uint32), b.view(np.uint32))

    def delta_equals_full(eng, tag: str) -> None:
        """The engine's last sweep was a delta refresh: a full sweep from
        the same features must give the same bits everywhere."""
        d_logits = eng._logits_host.copy()
        d_caches = eng._layers + eng._halos
        eng.full_sweep()
        check(same(d_logits, eng._logits_host),
              f"[serve-front] {tag}: delta refresh logits == full sweep's")
        for a, b in zip(d_caches, eng._layers + eng._halos):
            check(same_bits(a, b), f"[serve-front] {tag}: delta refresh "
                  f"caches == full sweep's")

    out: dict = {"launches": {}}
    train_step = np.array(TRAIN_LAUNCHES[("gcn", "sylvie_s", "sync")])
    with tempfile.TemporaryDirectory(prefix="serve_front_") as tmp:
        tmp = Path(tmp)
        # -- 1. GCN 256x2 serve_once on reddit_like@paper --------------------
        gcn_argv = ("--graph", "reddit_like@paper", "--arch", "gcn",
                    "--ckpt-dir", str(tmp / "gcn"), "--train-epochs", "3",
                    "--clients", "8", "--requests", "400", "--batch", "16",
                    "--refresh-every", "50", "--refresh-nodes", "64",
                    "--seed", str(SEED))
        rep, sweeps, total, secs, _ = serve(*gcn_argv)
        eng = sweeps[-1][0]
        check(sweeps[0][1] == "full" and sweeps[0][2] == SERVE_LAUNCHES["gcn"],
              f"[serve-front] gcn first sweep launches {sweeps[0][2]}, "
              f"expected {SERVE_LAUNCHES['gcn']}")
        check(all(s[2] == SERVE_LAUNCHES["gcn"] for s in sweeps),
              "[serve-front] gcn: every sweep launches SERVE_LAUNCHES")
        served = sum(np.array(s[2]) for s in sweeps)
        trained = total[[names.index(k) for k in TRAIN_KERNELS]] - served
        check(np.array_equal(trained, 3 * train_step),
              f"[serve-front] gcn: 3 training epochs launched {trained}, "
              f"expected 3 x {train_step}")
        load = rep["load"]
        check(load["requests"] == 400, f"[serve-front] gcn: "
              f"{load['requests']} of 400 requests completed")
        check(rep["delta_refresh"]["kind"] == "delta"
              and rep["delta_refresh"]["wire_bytes"]
              < rep["full_sweep_wire_bytes"],
              "[serve-front] gcn: the measured delta ships less than a full "
              "sweep")
        full_ms = sorted(s[3].seconds * 1e3 for s in sweeps
                         if s[1] == "full")
        delta_ms = sorted(s[3].seconds * 1e3 for s in sweeps
                          if s[1] == "delta")
        res = out["gcn"] = dict(
            qps=load["qps"], p50_ms=load["p50_ms"], p99_ms=load["p99_ms"],
            requests=load["requests"], refreshes=load["refreshes"],
            refresh_failures=load["refresh_failures"],
            first_sweep_ms=rep["sweep_seconds"] * 1e3,
            full_sweep_ms=full_ms,
            delta_ms_median=delta_ms[len(delta_ms) // 2],
            refresh_wire_bytes=load["refresh_wire_bytes"],
            delta_wire_bytes=rep["delta_refresh"]["wire_bytes"],
            full_sweep_wire_bytes=rep["full_sweep_wire_bytes"],
            sweeps=len(sweeps), seconds=secs)
        out["launches"]["gcn_serve_front_sweep"] = dict(
            zip(TRAIN_KERNELS, sweeps[0][2]))
        log(f"[serve-front] gcn reddit_like@paper serve_once (3 epochs "
            f"trained, 8 clients x 400 requests x 16 ids, 64-node delta "
            f"every 50): {json.dumps(res)}")
        final_logits = eng._logits_host.copy()
        delta_equals_full(eng, "gcn")

        # -- 4. degraded mode on the same engine -----------------------------
        before = eng._logits_host.copy()
        eng.set_down([1])
        rng = np.random.default_rng(SEED + 5)
        ids = rng.choice(eng.pg.part_of.size, size=64, replace=False)
        rows = rng.normal(0, 1, (64, eng.pg.x.shape[-1])).astype(np.float32)
        dsweeps: list = []
        with watching(dsweeps):
            drep = eng.refresh(ids, rows)
        check(drep.kind == "delta" and dsweeps[0][2] == SERVE_LAUNCHES["gcn"],
              f"[serve-front] degraded refresh ran {drep.kind} with launches "
              f"{dsweeps[0][2]}")
        check(same(eng._logits_host[1], before[1]),
              "[serve-front] partition 1's logits frozen bit for bit")
        check(eng.part_staleness.tolist() == [0, 1, 0, 0],
              f"[serve-front] staleness {eng.part_staleness.tolist()}")
        p1 = eng.pg.global_ids[1][eng.pg.node_mask[1]][:32]
        check(eng.query(p1).staleness.tolist() == [1] * 32,
              "[serve-front] partition 1's answers stamped stale")
        eng.set_up([1])
        eng.full_sweep()
        torch.manual_seed(SEED)
        fresh, _ = InferenceEngine.from_checkpoint(
            tmp / "gcn", configs.get("gcn").config().make(
                eng.pg.x.shape[-1], eng.pg.n_classes),
            dataclasses.replace(eng.pg, x=eng._x_host.copy()),
            config=eng.config, runtime=eng.runtime, seed=SEED)
        fresh.full_sweep()
        check(eng.part_staleness.tolist() == [0] * 4
              and same(eng._logits_host, fresh._logits_host),
              "[serve-front] after set_up + full_sweep the logits equal a "
              "fresh engine's bit for bit")
        log(f"[serve-front] degraded: partition 1 down, a 64-node delta "
            f"refresh ({drep.seconds * 1e3:.3f} ms, launches "
            f"{dsweeps[0][2]}) left its {int(eng.pg.node_mask[1].sum())} "
            f"logits rows frozen bit for bit, staleness [0, 1, 0, 0]; after "
            f"set_up + full_sweep the logits equal a fresh engine's bit for "
            f"bit")
        gcn_pg = eng.pg
        del eng, fresh, sweeps, dsweeps
        torch.cuda.empty_cache()

        # -- 2. GraphSAGE and GAT served the same way ------------------------
        for arch in ("graphsage", "gat"):
            rep, sweeps, total, secs, _ = serve(
                "--graph", "reddit_like@paper", "--arch", arch,
                "--ckpt-dir", str(tmp / arch), "--train-epochs", "3",
                "--requests", "100", "--refresh-nodes", "64",
                "--seed", str(SEED))
            check(all(s[2] == SERVE_LAUNCHES[arch] for s in sweeps),
                  f"[serve-front] {arch}: sweep launches "
                  f"{[s[2] for s in sweeps]}, expected "
                  f"{SERVE_LAUNCHES[arch]}")
            check(rep["load"]["requests"] == 100
                  and rep["delta_refresh"]["kind"] == "delta",
                  f"[serve-front] {arch}: 100 requests and a delta refresh")
            delta_equals_full(sweeps[-1][0], arch)
            out["launches"][f"{arch}_serve_front_sweep"] = dict(
                zip(TRAIN_KERNELS, sweeps[0][2]))
            res = out[arch] = dict(
                qps=rep["load"]["qps"], p50_ms=rep["load"]["p50_ms"],
                p99_ms=rep["load"]["p99_ms"],
                refresh_failures=rep["load"]["refresh_failures"],
                first_sweep_ms=rep["sweep_seconds"] * 1e3,
                delta_ms=rep["delta_refresh"]["seconds"] * 1e3,
                delta_wire_bytes=rep["delta_refresh"]["wire_bytes"],
                full_sweep_wire_bytes=rep["full_sweep_wire_bytes"],
                seconds=secs)
            log(f"[serve-front] {arch} reddit_like@paper serve_once: "
                f"{json.dumps(res)}; delta == full bit for bit")
            del sweeps
            torch.cuda.empty_cache()

        # -- 3. store, 2 replicas, open loop, mutation stream on gdelt --------
        base = ("--graph", "gdelt_like@paper", "--arch", "gcn",
                "--ckpt-dir", str(tmp / "gdelt"), "--train-epochs", "3",
                "--store", "--replicas", "2", "--requests", "1000",
                "--batch", "16", "--seed", str(SEED))
        closed, sweeps, *_ = serve(*base)
        qps = closed["load"]["qps"]
        obs.reset_metrics()
        # 50 ms consumption windows, so the stream's refreshes fall among
        # the requests (at 0.25 s the first is due after the last arrival)
        rep, sweeps, total, secs, lags = serve(
            *base, "--open-loop", "--qps", repr(qps / 2), "--skew", "1.1",
            "--stream-events", "60", "--stream-window", "0.05",
            "--slo-ms", "50")
        eng = sweeps[-1][0]
        load, st = rep["load"], rep["store"]
        check(len(lags) == load["refreshes"] > 0,
              f"[serve-front] open loop: {len(lags)} stream refreshes")
        check(load["completed"] + load["lost"] == 1000,
              f"[serve-front] open loop: {load['completed']} completed + "
              f"{load['lost']} lost != 1000")
        n_rows = eng.verify_store()
        lookups = load["completed"] * 16
        check(st["hits"] + st["misses"] == lookups
              and obs.snapshot()["counters"]["store.hits"] == st["hits"],
              f"[serve-front] store hits {st['hits']} + misses "
              f"{st['misses']} != {lookups} row lookups")
        check(all(s[2] == SERVE_LAUNCHES["gcn"] for s in sweeps),
              "[serve-front] gdelt: every sweep launches SERVE_LAUNCHES")
        # what the store adds to a sweep: the emb table's copy to the host
        t = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng._publish(None)
            t.append((time.perf_counter() - t0) * 1e3)
        emb = eng._layers[-1]
        res = out["gdelt"] = dict(
            closed_qps=qps, closed_p99_ms=closed["load"]["p99_ms"],
            offered_qps=load["qps_offered"],
            achieved_qps=load["qps_achieved"], completed=load["completed"],
            lost=load["lost"], p50_ms=load["p50_ms"], p99_ms=load["p99_ms"],
            slo_ms=load["slo_ms"], slo_pass=load["slo_pass"],
            hit_rate=st["hit_rate"], miss_bytes=st["miss_bytes"],
            cached_bytes=st["cached_bytes"], shard_bytes=st["shard_bytes"],
            refreshes=load["refreshes"],
            escalations=load["refresh_escalations"],
            refresh_failures=load["refresh_failures"],
            refresh_lag_p50_ms=float(np.percentile(lags, 50)) * 1e3,
            refresh_lag_p99_ms=float(np.percentile(lags, 99)) * 1e3,
            refresh_lag_max_ms=load["refresh_lag_max_s"] * 1e3,
            verified_rows=n_rows, emb_table_mb=emb.numel() * 4 / 1e6,
            publish_full_ms_median=sorted(t)[2],
            delta_ms=rep["delta_refresh"]["seconds"] * 1e3,
            replicas=rep["replicas"], seconds=secs)
        log(f"[serve-front] gdelt_like@paper store (4,096 kB cache), 2 "
            f"replicas, open loop at half the closed loop's QPS, Zipf 1.1, "
            f"60 stream events: {json.dumps(res)}")
        ids = rng.choice(eng.pg.part_of.size, size=64, replace=False)
        rows = rng.normal(0, 1, (64, eng.pg.x.shape[-1])).astype(np.float32)
        _, wall, busy, groups, _ = profile_device(
            lambda: eng.refresh(ids, rows),
            "one store-backed 64-node delta refresh on gdelt_like@paper")
        out["gdelt"]["profiled_delta"] = dict(host_ms=wall, busy_ms=busy,
                                              groups=groups)
        del eng, sweeps
        torch.cuda.empty_cache()

        # -- 5. tracing on: item 1's serving and 3 epochs of Sylvie-A --------
        # (1) again, restored (no training): untraced, then traced
        warm, wsweeps, wtotal, *_ = serve(*gcn_argv)
        obs.reset_metrics()
        obs.enable()
        rep5, sweeps5, total5, *_ = serve(*gcn_argv)
        serve_events = obs.drain()
        obs.disable()
        for tag, r, sw, tot in (("untraced", warm, wsweeps, wtotal),
                                ("traced", rep5, sweeps5, total5)):
            check(np.array_equal(tot, wtotal)
                  and np.array_equal(tot[[names.index(k)
                                          for k in TRAIN_KERNELS]], served)
                  and [s[2] for s in sw] == [SERVE_LAUNCHES["gcn"]] * len(sw)
                  and len(sw) == out["gcn"]["sweeps"],
                  f"[serve-front] {tag} serving launched {tot}, the first "
                  f"run's sweeps {served}")
            check(same(sw[-1][0]._logits_host, final_logits),
                  f"[serve-front] {tag} serving logits == the first run's, "
                  f"bit for bit")
            for k in ("requests", "refreshes", "refresh_wire_bytes"):
                check(r["load"][k] == out["gcn"][k],
                      f"[serve-front] {tag} {k} {r['load'][k]}")
        full_ms = sorted(s[3].seconds * 1e3 for s in wsweeps
                         if s[1] == "full")
        delta_ms = sorted(s[3].seconds * 1e3 for s in wsweeps
                          if s[1] == "delta")
        out["gcn"].update(warm_qps=warm["load"]["qps"],
                          warm_p50_ms=warm["load"]["p50_ms"],
                          warm_p99_ms=warm["load"]["p99_ms"],
                          warm_full_sweep_ms=full_ms,
                          warm_delta_ms_median=delta_ms[len(delta_ms) // 2])
        log(f"[serve-front] gcn serve_once again, restored, untraced: "
            f"{json.dumps({k: v for k, v in out['gcn'].items() if k.startswith('warm')})}")
        serve_spans = span_tree(serve_events)
        for name in ("admit", "request", "lookup", "refresh", "plan",
                     "sweep"):
            check(name in serve_spans, f"[serve-front] no {name} span")
        del sweeps5, wsweeps

        def sylvie_a(traced: bool) -> tuple:
            torch.manual_seed(SEED)
            model = configs.get("gcn").config().make(gcn_pg.x.shape[-1],
                                                     gcn_pg.n_classes)
            tr = GNNTrainer(model, gcn_pg, SylvieConfig(mode="async", bits=1),
                            policy=BoundedStaleness(eps_s=4, bits=1),
                            seed=SEED)
            (obs.enable if traced else obs.disable)()
            hist = []
            for _ in range(3):
                zero()
                m = tr.train_epoch()
                got = pinned(snap())
                check(got == TRAIN_LAUNCHES[("gcn", "sylvie_a", m.mode)],
                      f"[serve-front] Sylvie-A epoch {m.epoch} ({m.mode}, "
                      f"traced {traced}) launched {got}")
                hist.append(m)
            events = obs.drain()
            obs.disable()
            return hist, events
        plain, _ = sylvie_a(False)
        traced, train_events = sylvie_a(True)
        check([m.loss for m in plain] == [m.loss for m in traced]
              and [m.mode for m in traced] == ["sync", "async", "async"],
              f"[serve-front] traced losses {[m.loss for m in traced]} == "
              f"untraced {[m.loss for m in plain]}, bit for bit")
        check(all(m.wall_s >= m.seconds > 0.0 for m in plain + traced),
              "[serve-front] EpochMetrics.wall_s >= seconds")
        train_spans = span_tree(train_events)
        check({k: v[0] for k, v in train_spans.items()}
              == {"decide": 3, "epoch": 3, "step": 3},
              f"[serve-front] training spans {train_spans}")
        obs_dir = obs.default_obs_dir() / "chip_smoke"
        for run, events in (("serve", serve_events),
                            ("train", train_events)):
            trace = obs.write_trace(obs_dir / f"{run}.trace.json", events)
            obs.write_metrics(obs_dir / f"{run}.metrics.json",
                              metrics=obs.snapshot(),
                              run=f"chip_smoke/{run}",
                              trace_path=str(trace))
        out["spans"] = dict(serve=serve_spans, train=train_spans,
                            traced_qps=rep5["load"]["qps"],
                            traced_p50_ms=rep5["load"]["p50_ms"],
                            traced_p99_ms=rep5["load"]["p99_ms"],
                            untraced_qps=warm["load"]["qps"],
                            wall_ms=[m.wall_s * 1e3 for m in traced],
                            step_ms=[m.seconds * 1e3 for m in traced])
        log(f"[serve-front] traced (obs on): launches and logits / losses "
            f"bit-equal to the untraced runs; spans [count, median host ms] "
            f"{json.dumps(out['spans'])}; trace and metrics -> {obs_dir}")
    return out


CHAOS_EPOCHS = 20     # chaos_smoke's 6, extended for the epoch medians
CHAOS_FAULT = "drop=0.15,corrupt=0.05,seed=7"     # the chaos_smoke spec
CHAOS_ARCHS = ("gcn", "gat")


def stream_profile(fn, label: str) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and read its trace's device
    activities (kernels, copies, memsets) by CUDA stream: the device-busy ms
    (the union of every stream's intervals), each stream's busy ms, and the
    ms during which the main stream (the one with the most device time) and
    any other stream ran at once. The trace goes to ``build/``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = ROOT / "build" / f"chaos_profile_{label}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events)
    by_stream: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            sid = e.get("args", {}).get("stream", e.get("tid"))
            by_stream.setdefault(sid, []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def length(iv):
        return sum(b - a for a, b in iv)

    merged = {s: union(iv) for s, iv in by_stream.items()}
    main = max(merged, key=lambda s: length(merged[s])) if merged else None
    others = union([i for s, iv in merged.items() if s != main for i in iv])
    both, j = 0.0, 0
    for a, b in merged.get(main, []):
        while j < len(others) and others[j][1] <= a:
            j += 1
        k = j
        while k < len(others) and others[k][0] < b:
            both += min(b, others[k][1]) - max(a, others[k][0])
            k += 1
    res = dict(host_ms=wall,
               busy_ms=length(union([i for iv in by_stream.values()
                                     for i in iv])) / 1e3,
               streams={str(s): dict(busy_ms=length(iv) / 1e3,
                                     activities=len(by_stream[s]))
                        for s, iv in merged.items()},
               concurrent_ms=both / 1e3)
    log(f"[chaos] profile {label}: {json.dumps(res)}")
    return res


def chaos_phase(all_kernels: dict) -> dict:
    """Fault-tolerant training, the overlap schedule, kill-and-resume and
    the scenario runner on the card (see the module docstring)."""
    from repro_torch import configs, datasets
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.launch import scenarios
    from repro_torch.policy import BoundedStaleness, Uniform
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.trainer import GNNTrainer

    t_phase = time.perf_counter()
    names = list(all_kernels)

    def zero() -> None:
        for meta in all_kernels.values():
            meta["k"].launches = 0

    def counts() -> tuple:
        return tuple(all_kernels[k]["k"].launches for k in TRAIN_KERNELS)

    pg, _ = datasets.load_partitioned("reddit_like@paper", n_parts=4)
    d_in, n_cls = pg.x.shape[-1], pg.n_classes
    plan = scenarios.parse_fault(CHAOS_FAULT)
    runs = {"sylvie_s": (SylvieConfig(mode="sync", bits=1),
                         lambda: Uniform(bits=1)),
            "sylvie_a": (SylvieConfig(mode="async", bits=1),
                         lambda: BoundedStaleness(eps_s=4, bits=1))}
    out: dict = dict(launches={})

    def trainer(arch, cfg, pol, **kw):
        torch.manual_seed(SEED)
        model = configs.get(arch).config().make(d_in, n_cls)
        return GNNTrainer(model, pg, cfg, policy=pol, seed=SEED, **kw)

    # (a) faulted training at full width, beside the same runs fault-free,
    # their epochs in turns
    for arch in CHAOS_ARCHS:
        for name, (cfg, pol) in runs.items():
            trs = {key: trainer(arch, cfg, pol(), fault_plan=fp)
                   for key, fp in (("faulted", plan), ("clean", None))}
            for _ in range(CHAOS_EPOCHS):
                for key, tr in trs.items():
                    zero()
                    m = tr.train_epoch()
                    got = counts()
                    tag = f"[chaos] {arch} {name} {key} epoch {m.epoch} " \
                          f"({m.mode})"
                    recovery = m.forced_syncs > 0
                    want = TRAIN_LAUNCHES[(arch, "vanilla", "sync")
                                          if recovery else (arch, name,
                                                            m.mode)]
                    check(got == want and all_kernels["flash_fwd"]["k"]
                          .launches == 0,
                          f"{tag}: launches {got}, expected {want}")
                    drawn = plan.events(m.epoch, tr.n_sites, 4).n_injected \
                        if key == "faulted" else 0
                    check(m.faults_injected == drawn == m.halos_reused
                          + m.forced_syncs,
                          f"{tag}: injected {m.faults_injected} (the plan "
                          f"draws {drawn}) != reused {m.halos_reused} + "
                          f"forced {m.forced_syncs}")
                    if key == "faulted" and not recovery:
                        out["launches"][
                            f"{arch}_train_faulted_{name}_{m.mode}_step"] = {
                            k: all_kernels[k]["k"].launches for k in names}
            hist = {key: tr.history for key, tr in trs.items()}
            del trs
            for key, h in hist.items():
                check(all(np.isfinite([m.loss for m in h])),
                      f"[chaos] {arch} {name} {key}: losses finite "
                      f"{[m.loss for m in h]}")
            check(sum(m.faults_injected for m in hist["faulted"]) > 0,
                  f"[chaos] {arch} {name}: no fault injected")
            # epochs 1.. in the same mode in both runs, recovery epochs out
            pairs = [(f.seconds * 1e3, c.seconds * 1e3, f.mode)
                     for f, c in zip(hist["faulted"][1:], hist["clean"][1:])
                     if f.mode == c.mode and not f.forced_syncs]
            med = {}
            for mode in ("sync", "async"):
                fs = sorted(f for f, _, md in pairs if md == mode)
                cs = sorted(c for _, c, md in pairs if md == mode)
                ratio = sorted(f / c for f, c, md in pairs if md == mode)
                if fs:
                    med[mode] = dict(
                        faulted_ms=fs[len(fs) // 2],
                        clean_ms=cs[len(cs) // 2],
                        overhead=ratio[len(ratio) // 2] - 1.0,
                        epochs=len(fs))
            res = out[f"{arch}_{name}"] = dict(
                median=med,
                accounting=[(m.faults_injected, m.halos_reused,
                             m.forced_syncs, m.mode)
                            for m in hist["faulted"]],
                loss_faulted=[m.loss for m in hist["faulted"]],
                loss_clean=[m.loss for m in hist["clean"]])
            log(f"[chaos] {arch} {name} under {CHAOS_FAULT}, {CHAOS_EPOCHS} "
                f"epochs in turns with the same run fault-free: median epoch "
                f"ms by mode (epochs 1.., recovery epochs left out; overhead "
                f"= the median of the paired ratios - 1) "
                f"{json.dumps(med)}; per epoch (injected, reused, forced, "
                f"mode) {res['accounting']}; losses faulted "
                f"{[round(x, 4) for x in res['loss_faulted']]} clean "
                f"{[round(x, 4) for x in res['loss_clean']]}")
    torch.cuda.empty_cache()

    # (b) a rate-zero plan against no plan: the parameters bit for bit
    cfg, pol = runs["sylvie_s"]
    params = []
    for fp in (None, scenarios.parse_fault("seed=7")):
        tr = trainer("gcn", cfg, pol(), fault_plan=fp)
        tr.fit(3)
        params.append(optlib.tree_leaves(tr.state.params))
        del tr
    check(all(same_bits(a, b) for a, b in zip(*params)),
          "[chaos] a rate-zero plan trains the parameters of no plan")
    log("[chaos] GCN Sylvie-S, 3 epochs: a rate-zero plan's parameters equal "
        "no plan's bit for bit")

    # (c) overlap against blocking: bit-equal parameters, equal launches;
    # then one profiled async epoch under each schedule
    for arch in CHAOS_ARCHS:
        for mode in ("sync", "async"):
            res = {}
            for sched in ("blocking", "overlap"):
                tr = trainer(arch, SylvieConfig(mode=mode, bits=1,
                                                schedule=sched),
                             Uniform(bits=1))
                seen = []
                for _ in range(3):
                    zero()
                    m = tr.train_epoch()
                    seen.append((m.mode, tuple(
                        all_kernels[k]["k"].launches for k in names)))
                    if sched == "overlap":
                        out["launches"][f"{arch}_train_overlap_{m.mode}_"
                                        f"step"] = dict(zip(names,
                                                            seen[-1][1]))
                res[sched] = (seen, optlib.tree_leaves(tr.state.params),
                              [m.loss for m in tr.history],
                              [round(m.seconds * 1e3, 3) for m in tr.history])
                if mode == "async":
                    res[sched] += (stream_profile(
                        tr.train_epoch, f"{arch}_{sched}_async"),)
                del tr
            (sb, pb, lb), (so, po, lo) = (res["blocking"][:3],
                                          res["overlap"][:3])
            check(sb == so, f"[chaos] {arch} {mode}: launches per epoch "
                  f"blocking {sb} != overlap {so}")
            check(lb == lo and all(same_bits(a, b) for a, b in zip(pb, po)),
                  f"[chaos] {arch} {mode}: overlap parameters and losses "
                  f"{lo} bit-equal to blocking {lb}")
            log(f"[chaos] {arch} {mode}: 3 epochs, overlap == blocking bit "
                f"for bit (losses {lb}), launches equal {sb}; epoch ms "
                f"blocking {res['blocking'][3]} overlap "
                f"{res['overlap'][3]}")
            if mode == "async":
                out[f"{arch}_overlap_profile"] = {
                    s: res[s][4] for s in ("blocking", "overlap")}
    torch.cuda.empty_cache()

    # (d) kill-and-resume on the card, in worker processes
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.chaos", "--kill-resume",
           "--dataset", "reddit_like@paper", "--epochs", "4"]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    kr = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                        text=True, timeout=600)
    check(kr.returncode == 0, f"[chaos] kill-resume exited {kr.returncode}:"
          f"\n{kr.stdout}\n{kr.stderr}")
    report = json.loads(kr.stdout[kr.stdout.index("{"):])
    check('"bit_exact": true' in kr.stdout and report["bit_exact"],
          f"[chaos] kill-resume not bit-exact: {kr.stdout}")
    check(report["plan_cache_hits"][1:] == [True, True],
          f"[chaos] kill-resume legs 2 and 3 plan-cache hits: "
          f"{report['plan_cache_hits']}")
    out["kill_resume"] = dict(report, seconds=time.perf_counter() - t0)
    log(f"[chaos] kill-resume on reddit_like@paper (uniform:1 sync, 4 "
        f"epochs): {json.dumps(out['kill_resume'])}")

    # (e) the scenario runner on the card
    t0 = time.perf_counter()
    art = ROOT / "artifacts" / "torch" / "chip_smoke"
    reps = scenarios.run_scenario("chaos_smoke", out_dir=art / "scenarios")
    for rep in reps:
        check(rep["faults_injected"] == rep["halos_reused"]
              + rep["forced_syncs"] and rep["faults_injected"] > 0,
              f"[chaos] {rep['cell']}: accounting {rep['faults_injected']} "
              f"== {rep['halos_reused']} + {rep['forced_syncs']} > 0")
    cell = scenarios.resolve("smoke").cells()[0].cell_id
    (rep,) = scenarios.run_scenario("smoke", only=cell,
                                    out_dir=art / "scenarios",
                                    obs_trace=True, obs_dir=art / "obs")
    check(set(rep) == scenarios.REPORT_KEYS and rep["obs"]["enabled"]
          and Path(rep["trace_path"]).is_file(),
          f"[chaos] traced smoke cell: keys {sorted(rep)}, trace "
          f"{rep['trace_path']}")
    out["scenarios"] = dict(
        chaos_smoke={r["cell"]: [r["faults_injected"], r["halos_reused"],
                                 r["forced_syncs"], r["final_loss"]]
                     for r in reps},
        smoke_cell=cell, trace=rep["trace_path"],
        seconds=time.perf_counter() - t0)
    log(f"[chaos] scenarios: {json.dumps(out['scenarios'])}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[chaos] phase done in {out['seconds']:.1f} s")
    return out


def analysis_phase(pg, device: str = "cuda") -> dict:
    """[analysis], first half: ``repro_torch.analysis``'s simulated
    contracts on the card (their censuses hold kernel launches; RC206 runs
    ``quantize_pack`` / ``unpack_dequantize`` at bits 1, 2, 4 and 8), and
    the train-census contract at the main path's full width: one Sylvie-S
    epoch of GCN 256x2 on ``pg`` (``reddit_like@paper`` as [train]
    partitioned it, P = 4, 1 bit) held to the expectation over ``pg``'s own
    ring buckets, its launches exactly ``TRAIN_LAUNCHES``' Sylvie-S step and
    no other kernel. Any finding fails the script. The sharded contracts
    run in [sharded]'s spawn (``sharded_rank``). ``device="cpu"`` dry-runs
    it here (the plain versions: no launches)."""
    from repro_torch import configs
    from repro_torch.analysis import contracts
    from repro_torch.dist.runtime import Runtime

    t0 = time.perf_counter()
    found, _ = contracts.run_contracts(only=contracts.SIMULATED,
                                       device=device)
    sim_s = time.perf_counter() - t0
    torch.manual_seed(SEED)
    model = configs.get("gcn").config().make(pg.x.shape[-1], pg.n_classes)
    wide, c = contracts.contract_trainer_epoch(
        model, pg, Runtime.simulated(4, device=device),
        where="contract:train_epoch/gcn/reddit_like@paper/simulated")
    found += wide
    launched = dict(c.launches)
    got = tuple(launched.get(k, 0) for k in TRAIN_KERNELS)
    want = TRAIN_LAUNCHES[("gcn", "sylvie_s", "sync")]
    if device == "cpu":
        want = (0,) * len(want)
    check(not found, "[analysis] findings:\n"
          + "\n".join(f.render() for f in found))
    check(got == want and sum(launched.values()) == sum(want),
          f"[analysis] the full-width epoch launched {c.launched()}, "
          f"expected {dict(zip(TRAIN_KERNELS, want))} and nothing else")
    quant = [e for e in c.backend if e.method.startswith("exchange_q")]
    out = dict(contracts=len(contracts.SIMULATED) + 1, findings=0,
               simulated_s=sim_s, wide_s=time.perf_counter() - t0 - sim_s,
               wide_buckets=list(quant[0].bucket_sizes),
               wide_exchanges=[(e.reverse, e.arrays) for e in quant],
               wide_psums=len(c.methods("psum")))
    log(f"[analysis] simulated contracts on the card and the full-width "
        f"census: {json.dumps(out)}")
    return out


SHARDED_PARTS = 4
SHARDED_EPOCHS = 5
SHARDED_LABEL = "gloo, host-staged, four ranks on one card"
# the tolerance of a deterministic 1-bit run held against the simulated
# runtime: losses rtol 1e-4, halo rows apart (halo_rows_apart: rtol 1e-4;
# atol 1e-6 of the largest feature, 1e-3 of the largest gradient) at most
# 1% of the stack's rows (each rank multiplies its own rows, so cuBLAS may
# round a product otherwise and flip a 1-bit code, as in [train-parity]);
# at 32 bits losses rtol 1e-5
SHARDED_ONE_BIT_RTOL = 1e-4
SHARDED_ROWS_APART = 0.01
SHARDED_SGD_LR = 1e-1
SHARDED_ADAM_LR = 1e-2                 # the trainer's default optimizer


def sharded_runs() -> dict:
    """The training runs of [sharded] (b) and (c), each held against
    ``Runtime.simulated(4)`` on the card: name -> (arch, the run of
    ``TRAIN_LAUNCHES`` it launches as, config, policy, optimizer,
    epochs). Deterministic rounding, so that neither runtime draws noise.
    They train with SGD, as the reference's backend-parity test does, but
    for ``vanilla_adam``: the trainer's default Adam, gated on its losses
    and bytes and not on its halos. Adam divides each gradient by its own
    running magnitude, so a weight whose gradient is cancellation noise
    moves by about its learning rate either way, and the all-reduce's other
    order of sums (four partial sums, not one) can become differences of
    that size; (b) records the witness, the first step's parameter gap per
    leaf under either optimizer."""
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.policy import BoundedStaleness, Uniform
    det = dict(bits=1, stochastic=False)
    sync = (SylvieConfig(mode="sync", **det), Uniform(**det))
    asyn = (SylvieConfig(mode="async", **det),
            BoundedStaleness(eps_s=4, **det))
    vanilla = (SylvieConfig(mode="vanilla"), None)
    return {"vanilla": ("gcn", "vanilla", *vanilla, "sgd", SHARDED_EPOCHS),
            "vanilla_adam": ("gcn", "vanilla", *vanilla, "adam",
                             SHARDED_EPOCHS),
            "sylvie_s": ("gcn", "sylvie_s", *sync, "sgd", SHARDED_EPOCHS),
            "sylvie_a": ("gcn", "sylvie_a", *asyn, "sgd", SHARDED_EPOCHS),
            "gat_sylvie_a": ("gat", "sylvie_a", *asyn, "sgd", 2)}


def _sharded_opt(name: str):
    """(optimizer, learning rate) of a [sharded] run."""
    from repro_torch.train import optimizer as optlib
    if name == "adam":
        return optlib.adam(SHARDED_ADAM_LR), SHARDED_ADAM_LR
    return optlib.sgd(SHARDED_SGD_LR), SHARDED_SGD_LR


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def sharded_rank(graph: str, device: str) -> dict:
    """One rank of [sharded], inside ``dist.spawn`` (see ``sharded_phase``),
    on ``graph`` and ``device`` ("cuda:0"; "cpu" runs the plain versions).
    Raises on any failed check; returns, on rank 0, every rank's results."""
    import torch.distributed as dist

    from repro_torch import configs, datasets
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.dist.backend import SimulatedBackend
    from repro_torch.dist.runtime import Runtime
    from repro_torch.launch import scenarios
    from repro_torch.policy import Uniform
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.trainer import GNNTrainer

    kernels = {n: m["k"] for n, m in kernel_table().items()}
    rt = Runtime.sharded(SHARDED_PARTS, device=device)
    r, dev = rt.rank, rt.device
    be = rt.backend
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    out: dict = dict(rank=r, device=str(dev), backend=dist.get_backend(),
                     current=(f"cuda:{torch.cuda.current_device()}"
                              if dev.type == "cuda" else "cpu"))
    t0 = time.perf_counter()
    pg, hit = datasets.load_partitioned(graph, SHARDED_PARTS,
                                        group=dist.group.WORLD)
    out["load_s"], out["plan_cache_hit"] = time.perf_counter() - t0, hit
    d_in, n_cls = pg.x.shape[-1], pg.n_classes

    def zero():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return tuple(kernels[k].launches for k in TRAIN_KERNELS)

    def launched(want) -> bool:
        """The kernels launched as ``want`` (on the CPU, the plain
        versions: no kernel at all)."""
        return counts() == (want if dev.type == "cuda" else (0,) * len(want))

    # (a) the exchanges on the graph's own bucket sizes, bit for bit against
    # SimulatedBackend on the stacked CUDA tensor; each timed (host clock,
    # ending in a sync) with the bytes this rank sends
    sim = SimulatedBackend()
    buckets = tuple(int(b) for b in pg.plan.bucket_sizes)
    rows = {"dense": SHARDED_PARTS * int(pg.plan.h_pad),
            "compact": sum(buckets)}
    widths = {torch.uint8: 32, torch.bfloat16: 1, torch.float32: 256}
    gen = torch.Generator().manual_seed(SEED)
    exch = {}
    for layout in ("dense", "compact"):
        for dtype, w in widths.items():
            full = torch.randn((SHARDED_PARTS, rows[layout], w),
                               generator=gen) * 50
            full = (full.abs().to(torch.uint8) if dtype == torch.uint8
                    else full.to(dtype)).to(dev)
            mine = full[r:r + 1].contiguous()
            for rev in ((False,) if layout == "dense" else (False, True)):
                if layout == "dense":
                    want = sim.exchange(full)[r:r + 1]
                    fn = lambda: be.exchange(mine)  # noqa: E731
                    sent = mine.numel() * (SHARDED_PARTS - 1) \
                        // SHARDED_PARTS
                else:
                    want = sim.exchange_compact(full, buckets, rev)[r:r + 1]
                    fn = lambda: be.exchange_compact(  # noqa: E731
                        mine, buckets, rev)
                    sent = mine.numel() - buckets[0] * w
                got = fn()
                tag = f"{layout}{'-reversed' if rev else ''}-" \
                      f"{str(dtype).split('.')[1]}"
                check(same_bits(got, want), f"[sharded] rank {r} exchange "
                      f"{tag}: equals SimulatedBackend's row bit for bit")
                times = []
                for _ in range(5):
                    sync()
                    t = time.perf_counter()
                    fn()
                    sync()
                    times.append((time.perf_counter() - t) * 1e3)
                exch[tag] = dict(rows=rows[layout], width=w,
                                 bytes_sent=sent * mine.element_size(),
                                 median_ms=_median(times))
    out.update(exchange=exch, buckets=list(buckets),
               h_pad=int(pg.plan.h_pad))
    dist.barrier()

    # (b) GCN 256x2 and (c) GAT 4x64, deterministic, against the simulated
    # runtime: rank 0 trains each run on the whole stack first (the others
    # wait), then every rank trains its partition; the sharded state is
    # gathered (the checkpoints' gather) and held against the simulated one
    # on rank 0, with the parameters after the first step and the last
    def leaves(tr):
        return [p.detach().cpu().clone()
                for p in optlib.tree_leaves(tr.state.params)]

    out["train"] = {}
    for name, (arch, run, cfg, pol, opt, epochs) in sharded_runs().items():
        ref = None
        if r == 0:
            torch.manual_seed(SEED)
            tr = GNNTrainer(configs.get(arch).config().make(d_in, n_cls),
                            pg, cfg, policy=pol, seed=SEED,
                            opt=_sharded_opt(opt)[0],
                            runtime=Runtime.simulated(SHARDED_PARTS,
                                                      device=dev))
            ref = dict(p0=leaves(tr))
            for e in range(epochs):
                tr.train_epoch()
                if e == 0:
                    ref["p1"] = leaves(tr)
            ref.update(losses=[m.loss for m in tr.history],
                       mb=[(m.comm_payload_mb, m.comm_ec_mb)
                           for m in tr.history],
                       epoch_ms=[m.seconds * 1e3 for m in tr.history],
                       halo=tr.state.halo, pn=leaves(tr))
            del tr
        dist.barrier()
        torch.manual_seed(SEED)
        model = configs.get(arch).config().make(d_in, n_cls)
        tr = GNNTrainer(model, pg, cfg, policy=pol, runtime=rt, seed=SEED,
                        opt=_sharded_opt(opt)[0])
        p0, p1, launches = leaves(tr), None, []
        for _ in range(epochs):
            zero()
            m = tr.train_epoch()
            got, want = counts(), TRAIN_LAUNCHES[(arch, run, m.mode)]
            check(launched(want) and np.isfinite(m.loss),
                  f"[sharded] rank {r} {name} epoch {m.epoch} ({m.mode}): "
                  f"loss {m.loss}, launches {got}, expected {want}")
            launches.append((m.mode, dict(zip(TRAIN_KERNELS, got))))
            p1 = leaves(tr) if p1 is None else p1
        halo = rt.gather_state(tr.state).halo
        res = out["train"][name] = dict(
            losses=[m.loss for m in tr.history],
            rows=SHARDED_PARTS * int(tr.block.plan.halo_rows),
            mb=[(m.comm_payload_mb, m.comm_ec_mb) for m in tr.history],
            epoch_ms=[m.seconds * 1e3 for m in tr.history],
            median_ms={mode: _median([m.seconds * 1e3
                                      for m in tr.history[1:]
                                      if m.mode == mode])
                       for mode in ("sync", "async")},
            launches=launches)
        if ref is not None:
            lr = _sharded_opt(opt)[1]
            check(all(same_bits(a, b) for a, b in zip(p0, ref["p0"])),
                  f"[sharded] {name}: the initial parameters are the "
                  "simulated run's")
            res["simulated"] = {k: ref[k] for k in ("losses", "mb",
                                                    "epoch_ms")}
            res["rows_apart"] = dict(
                feats=[halo_rows_apart(a, b, 1e-6) for a, b in zip(
                    halo.feats, ref["halo"].feats)],
                grads=[halo_rows_apart(a, b, 1e-3) for a, b in zip(
                    halo.grads, ref["halo"].grads)])
            res["max_rel_diff"] = {k: [
                float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(getattr(halo, k), getattr(ref["halo"], k))]
                for k in ("feats", "grads")}
            # the witness, per parameter leaf: the first step's gap over the
            # learning rate (under SGD: the gradients' gap; under Adam a
            # sign flip of a gradient moves its weight by 2 lr), the largest
            # first-step move over the learning rate, the weights whose gap
            # exceeds lr / 10 after the first step, and the last step's gap
            # over the largest parameter
            res["param_gap"] = dict(
                lr=lr,
                step1_over_lr=[float((a - b).abs().max()) / lr
                               for a, b in zip(p1, ref["p1"])],
                step1_move_over_lr=[float((b - c).abs().max()) / lr
                                    for b, c in zip(ref["p1"], ref["p0"])],
                step1_over_tenth_lr=[int(((a - b).abs() > lr / 10).sum())
                                     for a, b in zip(p1, ref["p1"])],
                last_rel=[float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(leaves(tr), ref["pn"])])
        del tr, model, halo, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    out["zoo"] = sharded_zoo_rank(rt, graph_of=ZOO_ARCHS)

    # (d) faults under the chaos_smoke schedule; overlap against blocking
    plan = scenarios.parse_fault(CHAOS_FAULT)
    torch.manual_seed(SEED)
    tr = GNNTrainer(configs.get("gcn").config().make(d_in, n_cls), pg,
                    SylvieConfig(mode="sync", bits=1), policy=Uniform(bits=1),
                    runtime=rt, seed=SEED, fault_plan=plan)
    acct = []
    for _ in range(3):
        zero()
        m = tr.train_epoch()
        drawn = plan.events(m.epoch, tr.n_sites, SHARDED_PARTS).n_injected
        want = TRAIN_LAUNCHES[("gcn", "vanilla", "sync") if m.forced_syncs
                              else ("gcn", "sylvie_s", m.mode)]
        check(m.faults_injected == drawn == m.halos_reused + m.forced_syncs
              and launched(want) and np.isfinite(m.loss),
              f"[sharded] rank {r} faulted epoch {m.epoch}: injected "
              f"{m.faults_injected} (the plan draws {drawn}) == reused "
              f"{m.halos_reused} + forced {m.forced_syncs}; launches "
              f"{counts()} == {want}")
        acct.append((m.faults_injected, m.halos_reused, m.forced_syncs))
    check(sum(a[0] for a in acct) > 0, "[sharded] no fault injected")
    out["faults"] = dict(accounting=acct, losses=[m.loss for m in tr.history])
    del tr
    out["overlap"] = {}
    for mode in ("sync", "async"):
        res = {}
        for sched in ("blocking", "overlap"):
            torch.manual_seed(SEED)
            tr = GNNTrainer(configs.get("gcn").config().make(d_in, n_cls),
                            pg, SylvieConfig(mode=mode, bits=1,
                                             schedule=sched),
                            policy=Uniform(bits=1), runtime=rt, seed=SEED)
            seen = []
            for _ in range(3):
                zero()
                tr.train_epoch()
                seen.append(counts())
            res[sched] = (seen, optlib.tree_leaves(tr.state.params),
                          [m.loss for m in tr.history],
                          [m.seconds * 1e3 for m in tr.history])
            del tr
        (sb, pb, lb, _), (so, po, lo, _) = res["blocking"], res["overlap"]
        check(sb == so and lb == lo
              and all(same_bits(a, b) for a, b in zip(pb, po)),
              f"[sharded] rank {r} gcn {mode}: overlap (losses {lo}, "
              f"launches {so}) bit-equal to blocking ({lb}, {sb})")
        out["overlap"][mode] = dict(losses=lb,
                                    blocking_ms=res["blocking"][3],
                                    overlap_ms=res["overlap"][3])

    # [analysis], second half: the sharded census contracts on this rank
    # (every rank gets every rank's findings)
    from repro_torch.analysis import contracts
    t0 = time.perf_counter()
    found = contracts.run_sharded(contracts.SHARDED, device)
    out["analysis"] = dict(contracts=len(contracts.SHARDED),
                           findings=[f.render() for f in found],
                           seconds=time.perf_counter() - t0)
    check(not found, f"[sharded] rank {r}: census contracts found\n"
          + "\n".join(out["analysis"]["findings"]))
    every = [None] * SHARDED_PARTS
    dist.all_gather_object(every, out)
    return every


# [sharded], the zoo: PNA, MeshGraphNet, SchNet and NequIP at their full
# configs on ZOO_ARCHS' graphs, ZOO_SHARDED_EPOCHS epochs of vanilla and of
# Sylvie-A (BoundedStaleness(eps_s=4), 1 bit, deterministic), SGD at
# ZOO_ARCHS' rate, over four gloo ranks against Runtime.simulated(4)
ZOO_SHARDED_EPOCHS = 3
# MeshGraphNet's first loss is ~1e7: under SGD at its rate (1e-5) the first
# step overshoots to NaN (on the CPU too: 1.1e7, nan, nan); it trains with
# Adam at that rate, and is then gated on losses and bytes, its parameter
# gap and halo rows apart recorded (as [sharded]'s vanilla_adam)
ZOO_SHARDED_ADAM = ("meshgraphnet",)


def zoo_sharded_runs() -> dict:
    """The zoo's runs under the sharded runtime: name -> (config,
    policy)."""
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.policy import BoundedStaleness
    det = dict(bits=1, stochastic=False)
    return {"vanilla": (SylvieConfig(mode="vanilla"), None),
            "sylvie_a": (SylvieConfig(mode="async", **det),
                         BoundedStaleness(eps_s=4, **det))}


def zoo_train_runs(rt, graphs: dict, epochs: int, which: str = "config",
                   counts=None, around=None) -> dict:
    """Each zoo arch of ``graphs`` (arch -> graph) at its ``which`` config
    ("config" or "reduced") on its graph (``launch.train.gnn_graph``, P =
    4, seed ``SEED``), each run of :func:`zoo_sharded_runs` for ``epochs``
    epochs with SGD (Adam for ``ZOO_SHARDED_ADAM``) at ``ZOO_ARCHS``'
    rate, on runtime ``rt`` (simulated
    or sharded; the same calls). ``counts`` (``None``, or a function that
    zeroes nothing and returns counts in ``ZOO_KERNELS`` order) is read
    around each epoch; ``around(arch, run, epoch)`` (``None``, or a context
    manager) is entered before that read and left after it. Returns per (arch, run): losses, bytes per epoch,
    epoch ms, the layers, the final parameters (CPU), the gathered halo
    caches (CPU, a collective under a sharded runtime) and each epoch's
    (mode, launches)."""
    from repro_torch import configs
    from repro_torch.launch.train import gnn_graph
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.trainer import GNNTrainer

    out = {}
    for arch, graph in graphs.items():
        spec = getattr(configs.get(arch), which)()
        pg = gnn_graph(spec, graph, SHARDED_PARTS, SEED)
        for run, (cfg, pol) in zoo_sharded_runs().items():
            torch.manual_seed(SEED)
            model = spec.make(pg.x.shape[-1], pg.n_classes)
            opt = optlib.adam if arch in ZOO_SHARDED_ADAM else optlib.sgd
            tr = GNNTrainer(model, pg, cfg, policy=pol, runtime=rt,
                            seed=SEED, opt=opt(ZOO_ARCHS[arch][1]))
            launches = []
            for e in range(epochs):
                with (around(arch, run, e) if around
                      else contextlib.nullcontext()):
                    before = counts() if counts else None
                    m = tr.train_epoch()
                    if counts:
                        launches.append((m.mode, tuple(
                            a - b for a, b in zip(counts(), before))))
            halo = rt.gather_state(tr.state).halo
            out[arch, run] = dict(
                losses=[m.loss for m in tr.history],
                mb=[(m.comm_payload_mb, m.comm_ec_mb) for m in tr.history],
                epoch_ms=[m.seconds * 1e3 for m in tr.history],
                layers=len(model.comm_dims()),
                params=[p.detach().cpu() for p in
                        optlib.tree_leaves(tr.state.params)],
                halo=[[t.detach().cpu() for t in getattr(halo, k)]
                      for k in ("feats", "grads")],
                launches=launches)
            del tr, model, halo
    return out


def plain_counter():
    """Count the calls of each ``ZOO_KERNELS`` kernel's plain version in
    this process from now on (on the CPU the wrappers run them in the
    kernels' place); returns the function that reads the counts."""
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.kernels.seg import ref as segref
    from repro_torch.kernels.spmm import ref as sref

    refs = ((qref, "quantize_pack_ref"), (qref, "unpack_dequantize_ref"),
            (sref, "spmm_ref"), (segref, "seg_max_min_ref"),
            (segref, "seg_max_min_vjp_ref"))
    counts = [0] * len(refs)
    for i, (mod, fn) in enumerate(refs):
        real = getattr(mod, fn)

        def counted(*a, _real=real, _i=i, **k):
            counts[_i] += 1
            return _real(*a, **k)
        setattr(mod, fn, counted)
    return lambda: tuple(counts)


def sharded_zoo_kernels(rec: dict, tag: str) -> dict:
    """The kernels of one recorded step on a rank's own block: its SpMM
    (over the block's ``ecsr``, ``ecsr_t`` and scatter CSR) and quantize
    calls by :func:`recorded_kernels`, its dequantize calls bit-equal to
    the plain version (scale and zero as the step gave them), and PNA's
    ``seg_max_min`` and its backward by :func:`seg_recorded`. Returns the
    largest errors by kernel and the calls checked, in ``ZOO_KERNELS``
    order (``calls``)."""
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref

    res = recorded_kernels(rec, tag)
    for i, (pk, s_, z_, b, d) in enumerate(rec["dequantize"]):
        got = qops.dequantize_rows(pk, s_, z_, b, d)
        want = qref.unpack_dequantize_ref(pk, s_.float(), z_.float(), b, d)
        check(same_bits(got, want), f"{tag}: dequantize call {i} "
              f"{tuple(pk.shape)} bit-equal to the plain version")
        res["unpack_dequantize"] = max(res["unpack_dequantize"],
                                       float((got - want).abs().max()))
    seg = seg_recorded(rec["seg"], rec["seg_bwd"], tag)
    res.update(seg_max_min_csr=seg["seg_max_min_csr"],
               seg_max_min_bwd_csr=seg["seg_max_min_bwd_csr"],
               calls=(len(rec["quantize"]), len(rec["dequantize"]),
                      res.pop("spmm_calls"), seg["seg_calls"],
                      seg["seg_bwd_calls"]))
    del res["quantize_calls"]
    return res


def sharded_zoo_rank(rt, graph_of: dict, which: str = "config",
                     epochs: int = ZOO_SHARDED_EPOCHS,
                     counts=None) -> dict:
    """[sharded] (g), in one rank: the zoo (:func:`zoo_train_runs`, each
    arch on ``graph_of[arch][0]``) trained by rank 0 on
    ``Runtime.simulated(4)`` on its device first (the others wait), then by
    every rank on its partition, the launches of each epoch read by
    ``counts`` (default: the kernels' launches; on the CPU pass
    :func:`plain_counter`'s) and held to :func:`zoo_step_launches`. Each
    arch's first Sylvie-A epoch (a sync step) is recorded on every rank,
    and its kernels held to their plain versions at the rank's own shapes
    (:func:`sharded_zoo_kernels`), as many calls as its launches. Rank 0
    holds each run against the simulated one: the largest relative loss
    gap, the parameters' largest gap, the bytes, and the gathered halo
    caches' rows apart (:func:`halo_rows_apart`). Returns, per run, those
    numbers and the epoch ms, and for Sylvie-A the kernels checked."""
    import torch.distributed as dist

    from repro_torch.core import exchange as X
    from repro_torch.dist.runtime import Runtime
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.models.gnn import blocks as B

    r, dev = rt.rank, rt.device
    graphs = {arch: g[0] for arch, g in graph_of.items()}
    if counts is None:
        kernels = {n: m["k"] for n, m in kernel_table().items()}

        def counts():
            return tuple(kernels[k].launches for k in ZOO_KERNELS)
    checked = {}

    @contextlib.contextmanager
    def around(arch, run, epoch):
        if run != "sylvie_a" or epoch:
            yield
            return
        rec = {k: [] for k in ("aggregate", "scatter", "quantize",
                               "dequantize", "seg", "seg_bwd")}
        with recording(B, "spmm", rec["aggregate"]), \
                recording(X, "spmm", rec["scatter"]), \
                recording(qops, "quantize_pack_rows", rec["quantize"]), \
                recording(qops, "dequantize_rows", rec["dequantize"]), \
                recording(B, "seg_max_min", rec["seg"]), \
                recording(B, "seg_max_min_bwd", rec["seg_bwd"]):
            yield
        checked[arch] = sharded_zoo_kernels(
            rec, f"[sharded] rank {r} zoo {arch} {run} epoch 0")
        del rec

    sim = None
    if r == 0:
        sim = zoo_train_runs(Runtime.simulated(SHARDED_PARTS, device=dev),
                             graphs, epochs, which)
    dist.barrier()
    mine = zoo_train_runs(rt, graphs, epochs, which, counts=counts,
                          around=around)
    out = {}
    for (arch, run), res in mine.items():
        tag = f"[sharded] rank {r} zoo {arch} {run}"
        want = zoo_step_launches(arch, run, res["layers"])
        for e, (mode, got) in enumerate(res["launches"]):
            check(got == want, f"{tag} epoch {e} ({mode}): launches "
                  f"{dict(zip(ZOO_KERNELS, got))}, expected "
                  f"{dict(zip(ZOO_KERNELS, want))}")
        check(all(np.isfinite(res["losses"])), f"{tag}: losses "
              f"{res['losses']} finite")
        z = dict(losses=res["losses"], mb=res["mb"],
                 epoch_ms=res["epoch_ms"],
                 median_epoch_ms=_median(res["epoch_ms"][1:]),
                 launches=res["launches"], layers=res["layers"],
                 rows=SHARDED_PARTS * res["halo"][0][0].shape[1])
        if run == "sylvie_a":
            k = z["kernels"] = checked.pop(arch)
            check(res["launches"][0][0] == "sync" and k["calls"] == want,
                  f"{tag}: the recorded epoch 0 ({res['launches'][0][0]}) "
                  f"called {dict(zip(ZOO_KERNELS, k['calls']))}, expected "
                  f"a sync step's {dict(zip(ZOO_KERNELS, want))}")
        if sim is not None:
            ref = sim[arch, run]
            z["simulated"] = {k: ref[k] for k in ("losses", "mb",
                                                  "epoch_ms")}
            z["loss_max_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
                res["losses"], ref["losses"]))
            z["param_max_abs"] = max(float((a - b).abs().max())
                                     for a, b in zip(res["params"],
                                                     ref["params"]))
            z["rows_apart"] = dict(
                feats=[halo_rows_apart(a, b, 1e-6) for a, b in zip(
                    res["halo"][0], ref["halo"][0])],
                grads=[halo_rows_apart(a, b, 1e-3) for a, b in zip(
                    res["halo"][1], ref["halo"][1])])
        out[f"{arch}_{run}"] = z
    del sim, mine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def sharded_zoo_check(ranks: list, label: str) -> dict:
    """[sharded] (g)'s gates over every rank's :func:`sharded_zoo_rank`:
    each run's losses the same on every rank; against the simulated runtime
    vanilla's losses within rtol 1e-5 and parameters within 1e-5, Sylvie-A's
    losses within ``SHARDED_ONE_BIT_RTOL`` and its halo rows apart at most
    ``SHARDED_ROWS_APART`` of the stack's; bytes per epoch equal. An arch
    of ``ZOO_SHARDED_ADAM`` is gated on its losses and bytes alone (Adam
    turns ulps of a gradient into moves of its rate), the rest recorded.
    Returns the launches per step by path, each run's figures and the
    largest errors of the kernels every rank checked (``kernels``)."""
    out = dict(launches={}, kernels=dict.fromkeys(ZOO_KERNELS, 0.0))
    calls = {}
    for x in ranks:
        for key, z in x["zoo"].items():
            if "kernels" in z:
                for name in ZOO_KERNELS:
                    out["kernels"][name] = max(out["kernels"][name],
                                               z["kernels"][name])
                calls.setdefault(key.split("_", 1)[0], {})[x["rank"]] = \
                    dict(zip(ZOO_KERNELS, z["kernels"]["calls"]))
    out["kernels"]["calls"] = calls
    log(f"[sharded] (g) zoo: one Sylvie-A sync step of each arch on every "
        f"rank, its kernels at the rank's own shapes bit-equal to their "
        f"plain versions and twice: {json.dumps(out['kernels'])}")
    for key, z in ranks[0]["zoo"].items():
        arch, run = key.split("_", 1)
        got = [x["zoo"][key] for x in ranks]
        tag = f"[sharded] (g) zoo {key}"
        check(all(g["losses"] == z["losses"] for g in got),
              f"{tag}: every rank's losses are the same")
        rtol = 1e-5 if run == "vanilla" else SHARDED_ONE_BIT_RTOL
        check(z["loss_max_rel"] <= rtol, f"{tag}: sharded losses "
              f"{z['losses']} vs simulated {z['simulated']['losses']} (rtol "
              f"{rtol})")
        check(all(g["mb"] == z["simulated"]["mb"] for g in got),
              f"{tag}: bytes per epoch {z['mb']} vs {z['simulated']['mb']}")
        apart = z["rows_apart"]
        if arch in ZOO_SHARDED_ADAM:
            pass                        # recorded below, not gated
        elif run == "vanilla":
            check(z["param_max_abs"] <= 1e-5, f"{tag}: parameters "
                  f"{z['param_max_abs']} apart (atol 1e-5)")
        else:
            bound = SHARDED_ROWS_APART * z["rows"]
            check(max(apart["feats"] + apart["grads"]) <= bound,
                  f"{tag}: halo rows apart {apart} of {z['rows']} (bound "
                  f"{bound})")
        for mode, counts in z["launches"]:
            out["launches"][f"{arch}_train_sharded_{run}_{mode}_step"] = \
                dict(zip(ZOO_KERNELS, counts))
        res = out[key] = dict(
            loss_max_rel=z["loss_max_rel"], rtol=rtol,
            param_max_abs=z["param_max_abs"], rows_apart=apart,
            rows=z["rows"], losses=z["losses"], mb=z["mb"][-1],
            median_epoch_ms={x["rank"]: x["zoo"][key]["median_epoch_ms"]
                             for x in ranks},
            simulated_epoch_ms=z["simulated"]["epoch_ms"])
        opt = "Adam" if arch in ZOO_SHARDED_ADAM else "SGD"
        log(f"[sharded] (g) zoo {key}, {len(z['losses'])} epochs, {opt} "
            f"{ZOO_ARCHS[arch][1]:g}, against Runtime.simulated(4): "
            f"{json.dumps(res)}; launches exact on every rank; epoch ms "
            f"({label}, host clock)")
    return out


def sharded_zoo_only_rank(device: str, graph_of: dict, which: str,
                          epochs: int) -> list:
    """One rank of :func:`sharded_zoo_phase`: [sharded] (g) alone."""
    import torch.distributed as dist

    from repro_torch.dist.runtime import Runtime

    rt = Runtime.sharded(SHARDED_PARTS, device=device)
    counts = None if rt.device.type == "cuda" else plain_counter()
    out = dict(rank=rt.rank, zoo=sharded_zoo_rank(rt, graph_of, which,
                                                  epochs, counts))
    every = [None] * SHARDED_PARTS
    dist.all_gather_object(every, out)
    return every


def sharded_zoo_phase(card_line: str, device: str = "cuda:0",
                      graph_of: dict = ZOO_ARCHS, which: str = "config",
                      epochs: int = ZOO_SHARDED_EPOCHS) -> dict:
    """[sharded] (g) alone: the zoo over four ``gloo`` ranks on ``device``
    against ``Runtime.simulated(4)``, gated by :func:`sharded_zoo_check`
    (``[sharded]`` runs the same inside its own spawn). A CPU dry run:
    ``device="cpu"``, ``graph_of={a: (g, None) for a, g in
    ZOO_SMOKE.items()}``, ``which="reduced"`` (each rank counts the plain
    versions, :func:`plain_counter`)."""
    from repro_torch.dist.spawn import spawn

    t0 = time.perf_counter()
    ranks = spawn(sharded_zoo_only_rank, SHARDED_PARTS, device=device,
                  dist_backend="gloo", args=(device, graph_of, which,
                                              epochs), timeout=900)
    out = sharded_zoo_check(ranks, f"{SHARDED_LABEL}; {card_line}")
    out["seconds"] = time.perf_counter() - t0
    log(f"[sharded] (g) alone done in {out['seconds']:.1f} s")
    return out


def sharded_phase(card_line: str, graph: str = "reddit_like@paper",
                  device: str = "cuda:0") -> dict:
    """[sharded]: the multi-process runtime (``Runtime.sharded``), four
    ranks on ``cuda:0`` over ``gloo`` (NCCL refuses two ranks on one
    device), spawned by ``repro_torch.dist.spawn``; see the module
    docstring. The ranks raise on a failed check of their own, and so does
    ``spawn``; what compares ranks or runtimes is checked here."""
    from repro_torch.dist.spawn import spawn

    t0 = time.perf_counter()
    ranks = spawn(sharded_rank, SHARDED_PARTS, device=device,
                  dist_backend="gloo", args=(graph, device), timeout=600)
    log("[sharded] " + "; ".join(
        f"rank {x['rank']}: backend {x['backend']}, device {x['device']} "
        f"(current {x['current']})" for x in ranks))
    label = f"{SHARDED_LABEL}; {card_line}"
    log(f"[sharded] (a) exchanges on {graph}'s ring buckets "
        f"{ranks[0]['buckets']} and dense blocks (h_pad "
        f"{ranks[0]['h_pad']}), uint8 / bfloat16 / float32, compact both "
        f"ways: every rank's row bit-equal to SimulatedBackend on the "
        f"stacked CUDA tensor")
    out: dict = dict(launches={}, label=label)
    for name, (arch, _, cfg, _, opt, epochs) in sharded_runs().items():
        key = name if name.startswith(arch) else f"{arch}_{name}"
        got = [x["train"][name] for x in ranks]
        want = got[0]["simulated"]
        rtol = 1e-5 if cfg.mode == "vanilla" else SHARDED_ONE_BIT_RTOL
        err = max(abs(a - b) / abs(b) for a, b in zip(got[0]["losses"],
                                                        want["losses"]))
        check(all(g["losses"] == got[0]["losses"] for g in got),
              f"[sharded] {key}: every rank's losses are the same")
        check(np.allclose(got[0]["losses"], want["losses"], rtol=rtol,
                          atol=0),
              f"[sharded] {key}: sharded losses {got[0]['losses']} vs "
              f"simulated {want['losses']} (rtol {rtol})")
        check(all(g["mb"] == want["mb"] for g in got),
              f"[sharded] {key}: bytes per epoch {got[0]['mb']} vs "
              f"{want['mb']}")
        apart, n_rows = got[0]["rows_apart"], got[0]["rows"]
        # Adam's halos are recorded, not gated (see sharded_runs)
        bound = (None if opt == "adam" else 0 if cfg.mode == "vanilla"
                 else SHARDED_ROWS_APART * n_rows)
        check(bound is None or max(apart["feats"] + apart["grads"]) <= bound,
              f"[sharded] {key}: halo rows apart {apart} of {n_rows} "
              f"(bound {bound}; largest difference over the largest value "
              f"{got[0]['max_rel_diff']})")
        res = out[key] = dict(
            loss_max_rel=err, rtol=rtol, rows_apart=apart, rows=n_rows,
            rows_apart_bound=bound,
            halo_max_rel_diff=got[0]["max_rel_diff"],
            param_gap=got[0]["param_gap"],
            losses=got[0]["losses"], mb=got[0]["mb"][-1],
            median_epoch_ms={x["rank"]: x["train"][name]["median_ms"]
                             for x in ranks},
            simulated_epoch_ms=want["epoch_ms"])
        run = name.removeprefix(f"{arch}_")
        for mode, counts in got[0]["launches"]:
            out["launches"][f"{arch}_train_sharded_{run}_{mode}_step"] = \
                counts
        log(f"[sharded] ({'c' if arch == 'gat' else 'b'}) {key} ({opt}), "
            f"{epochs} epochs against Runtime.simulated(4) on the card: "
            f"{json.dumps(res)}; launches exact on every rank; epoch ms "
            f"({label}, host clock)")
    zoo = sharded_zoo_check(ranks, label)
    out["launches"].update(zoo.pop("launches"))
    out["zoo"] = zoo
    check(all(x["faults"]["accounting"] == ranks[0]["faults"]["accounting"]
              for x in ranks), "[sharded] the fault accounting is the same "
          "on every rank")
    log(f"[sharded] (d) gcn Sylvie-S under {CHAOS_FAULT}, 3 epochs: "
        f"(injected, reused, forced) {ranks[0]['faults']['accounting']} on "
        f"every rank; overlap == blocking bit for bit, sync and async, "
        f"launches equal: {json.dumps(ranks[0]['overlap'])}")
    log(f"[sharded] (e) {label}: per rank, median epoch ms (host clock; "
        f"epochs 1..): " + json.dumps({
            k: v["median_epoch_ms"] for k, v in out.items()
            if isinstance(v, dict) and "median_epoch_ms" in v}))
    coll = {tag: dict(rows=e["rows"], width=e["width"],
                      bytes_sent=[x["exchange"][tag]["bytes_sent"]
                                  for x in ranks],
                      ms=[x["exchange"][tag]["median_ms"] for x in ranks])
            for tag, e in ranks[0]["exchange"].items()}
    out["collectives"] = coll
    log(f"[sharded] (e) one collective ({label}; per rank: the bytes it "
        f"sends, the median of 5 on the host clock ending in a sync): "
        f"{json.dumps(coll)}")
    out["analysis"] = dict(ranks[0]["analysis"],
                           seconds=max(x["analysis"]["seconds"]
                                       for x in ranks))
    out["seconds"] = time.perf_counter() - t0
    log(f"[sharded] phase done in {out['seconds']:.1f} s (their plan load "
        f"{ranks[0]['load_s']:.1f} s, plan-cache hit "
        f"{ranks[0]['plan_cache_hit']})")
    return out


SERVE_SHARDED_ARCHS = ("gcn", "graphsage", "gat")
SERVE_SHARDED_BITS = (32, 1)
SERVE_SHARDED_CLIENTS = 8
SERVE_SHARDED_REQUESTS = 400
SERVE_SHARDED_BATCH = 16
SERVE_SHARDED_EVERY = 50
SERVE_SHARDED_NODES = 64


def _serve_parity_front(eng, ids, rows) -> dict:
    """[sharded-serve] (a)-(b): a full sweep, the 64-node delta, a fresh
    full sweep (run on rank 0 inside ``lead``, and on the stack)."""
    full = eng.full_sweep()
    out = dict(full=eng._logits_host.copy(), full_bytes=full.wire_bytes)
    rep = eng.refresh(ids, rows)
    out.update(delta=eng._logits_host.copy(), kind=rep.kind,
               affected=rep.affected_rows, bytes=rep.wire_bytes)
    eng.full_sweep()
    out["again"] = eng._logits_host.copy()
    return out


def _serve_degraded_front(eng, ids, rows) -> dict:
    """[sharded-serve] (d): partition 2 down, then a delta refresh."""
    eng.full_sweep()
    before = eng._logits_host.copy()
    eng.set_down([2])
    rep = eng.refresh(ids, rows)
    return dict(kind=rep.kind, before=before, logits=eng._logits_host.copy(),
                staleness=eng.part_staleness.tolist())


def _serve_load_front(eng, ids) -> dict:
    """[sharded-serve] (e): the closed loop through an ``EmbeddingServer``
    with a delta every ``SERVE_SHARDED_EVERY`` completions, traced; then the
    store's check and the publish of a delta's rows, timed."""
    from repro_torch import obs
    from repro_torch.serve import EmbeddingServer
    from repro_torch.serve.loadgen import closed_loop
    eng.full_sweep()
    obs.enable()
    srv = EmbeddingServer(eng)
    load = closed_loop(srv, eng.pg.part_of.size,
                       clients=SERVE_SHARDED_CLIENTS,
                       batch=SERVE_SHARDED_BATCH,
                       requests=SERVE_SHARDED_REQUESTS, seed=SEED,
                       refresh_every=SERVE_SHARDED_EVERY,
                       refresh_nodes=SERVE_SHARDED_NODES)
    events = obs.drain()
    obs.disable()
    verified = eng.verify_store()
    publish = []
    for _ in range(5):
        t = time.perf_counter()
        eng._publish(ids)
        publish.append((time.perf_counter() - t) * 1e3)
    return dict(load=load, health=srv.health, verified=verified,
                spans=span_tree(events), publish_ms=publish,
                store=eng.store.stats().as_dict())


def sharded_serve_rank(graph: str, device: str) -> dict:
    """One rank of [sharded-serve], inside ``dist.spawn`` (see
    ``sharded_serve_phase``), on ``graph`` and ``device`` ("cuda:0"; "cpu"
    runs the plain versions). Every rank builds the sharded engines and
    calls their ``lead``; rank 0 runs the fronts and, first, the simulated
    engine on the whole stack. Raises on a failed check; returns, on rank
    0, its results and every rank's launches and device ms."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, datasets
    from repro_torch.dist.runtime import Runtime
    from repro_torch.serve import InferenceEngine, ServeConfig
    from repro_torch.store import ShardedEmbeddingStore

    kernels = {n: m["k"] for n, m in kernel_table().items()}
    rt = Runtime.sharded(SHARDED_PARTS, device=device)
    r, dev = rt.rank, rt.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    t0 = time.perf_counter()
    pg, _ = datasets.load_partitioned(graph, SHARDED_PARTS,
                                      group=dist.group.WORLD)
    d_in, n_cls, n = pg.x.shape[-1], pg.n_classes, pg.part_of.size
    rng = np.random.default_rng(SEED)
    ids = rng.choice(n, SERVE_SHARDED_NODES, replace=False)
    rows = rng.normal(0, 1, (ids.size, d_in)).astype(np.float32)

    def zero():
        for k in kernels.values():
            k.launches = 0

    def counts():
        sync()
        return tuple(kernels[k].launches for k in TRAIN_KERNELS)

    def engine(arch, runtime, store=False, **kw):
        """``arch`` at the paper's widths, deterministic rounding; with
        ``store``, rank 0's store (4,096 kB of cache)."""
        torch.manual_seed(SEED)       # the same weights on every rank
        return InferenceEngine(
            configs.get(arch).config().make(d_in, n_cls), pg,
            config=ServeConfig(stochastic=False, **kw), runtime=runtime,
            seed=SEED, store=ShardedEmbeddingStore(cache_bytes=4096 << 10)
            if store and r == 0 else None)

    def on_stack(front, arch, *args, **kw):
        """Rank 0 runs ``front`` on ``Runtime.simulated(4)`` on the card
        first; the other ranks wait."""
        got = None
        if r == 0:
            got = engine(arch, Runtime.simulated(SHARDED_PARTS, device=dev),
                         **kw).lead(front, *args)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
        return got

    out: dict = dict(rank=r, load_s=time.perf_counter() - t0, parity={},
                     launches={})
    # (a)-(c): every arch at 32 and 1 bit against the stack; then, per
    # rank, the launches of one full sweep and of one delta
    for arch in SERVE_SHARDED_ARCHS:
        for bits in SERVE_SHARDED_BITS:
            want = on_stack(_serve_parity_front, arch, ids, rows, bits=bits)
            eng = engine(arch, rt, bits=bits)
            got = eng.lead(_serve_parity_front, ids, rows)
            zero()
            eng.lead(lambda e: e.full_sweep())
            full = counts()
            zero()
            eng.lead(lambda e: e.refresh(ids, rows))
            delta = counts()
            if bits == 1:
                expect = SERVE_LAUNCHES[arch] if dev.type == "cuda" else \
                    (0,) * len(TRAIN_KERNELS)
                check(full == delta == expect,
                      f"[sharded-serve] rank {r} {arch}: launches of a full "
                      f"sweep {full} and a delta {delta}, expected {expect}")
                out["launches"][f"{arch}_serve_sharded_sweep"] = dict(
                    zip(TRAIN_KERNELS, full))
            if r == 0:
                apart = {k: int((got[k] != want[k]).any(-1).sum())
                         for k in ("full", "delta", "again")}
                check(all(same_bits(torch.from_numpy(got[k]),
                                    torch.from_numpy(want[k]))
                          for k in ("full", "delta", "again")),
                      f"[sharded-serve] {arch} at {bits} bits: logits rows "
                      f"apart from Runtime.simulated(4)'s {apart}")
                check(same_bits(torch.from_numpy(got["delta"]),
                                torch.from_numpy(got["again"])),
                      f"[sharded-serve] {arch} at {bits} bits: the delta "
                      f"equals a fresh full sweep bit for bit")
                check(got["kind"] == want["kind"] == "delta"
                      and (got["affected"], got["bytes"], got["full_bytes"])
                      == (want["affected"], want["bytes"],
                          want["full_bytes"]),
                      f"[sharded-serve] {arch} at {bits} bits: delta "
                      f"{got['kind']}, rows {got['affected']}, bytes "
                      f"{got['bytes']} / {got['full_bytes']} vs simulated "
                      f"{want['affected']}, {want['bytes']} / "
                      f"{want['full_bytes']}")
                check(bool(np.isfinite(got["full"]).all()),
                      f"[sharded-serve] {arch} at {bits} bits: finite")
                out["parity"][f"{arch}_{bits}"] = dict(
                    rows_apart=apart, affected_rows=list(got["affected"]),
                    delta_bytes=got["bytes"], full_bytes=got["full_bytes"],
                    full_launches=full, delta_launches=delta)
            del eng
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    # (d) degraded mode: partition 2 down, then a delta refresh
    want = on_stack(_serve_degraded_front, "gcn", ids, rows, bits=1)
    got = engine("gcn", rt, bits=1).lead(_serve_degraded_front, ids, rows)
    if r == 0:
        check(got["kind"] == want["kind"] == "delta"
              and same_bits(torch.from_numpy(got["logits"]),
                            torch.from_numpy(want["logits"]))
              and got["staleness"] == want["staleness"] == [0, 0, 1, 0]
              and same_bits(torch.from_numpy(got["logits"][2]),
                            torch.from_numpy(got["before"][2])),
              f"[sharded-serve] degraded: partition 2 down, a delta: "
              f"staleness {got['staleness']} vs {want['staleness']}, "
              f"logits equal the simulated engine's and partition 2's "
              f"frozen")
        out["degraded"] = dict(staleness=got["staleness"],
                               frozen_rows=int(pg.node_mask[2].sum()))

    # (e) the front on rank 0: server, closed loop, store; then one full
    # sweep profiled on each rank in turn
    eng = engine("gcn", rt, bits=1, store=True)
    front = eng.lead(_serve_load_front, ids)
    busy = []
    for k in range(SHARDED_PARTS):
        if r == k and dev.type == "cuda":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                eng.lead(lambda e: e.full_sweep())
            on_dev = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            copies = [e for e in on_dev if e.key.startswith("Memcpy")]
            busy = [sum(e.self_device_time_total for e in on_dev) / 1e3,
                    sum(e.self_device_time_total for e in copies) / 1e3,
                    sum(e.count for e in on_dev)]
        else:
            eng.lead(lambda e: e.full_sweep())
    if r == 0:
        load = front["load"]
        want_refreshes = SERVE_SHARDED_REQUESTS // SERVE_SHARDED_EVERY
        check(load["requests"] == SERVE_SHARDED_REQUESTS
              and load["refreshes"] == want_refreshes
              and load["refresh_failures"] == 0
              and front["health"] == "healthy" and front["verified"] > 0,
              f"[sharded-serve] front: {load['requests']} requests, "
              f"{load['refreshes']} refreshes (expected {want_refreshes}), "
              f"{load['refresh_failures']} failed, health "
              f"{front['health']}, {front['verified']} store rows verified")
        for name in ("refresh", "plan", "sweep", "gather"):
            check(name in front["spans"], f"[sharded-serve] no {name} span")
        out["front"] = front
    out["sweep_device"] = busy
    every = [None] * SHARDED_PARTS
    dist.all_gather_object(every, dict(rank=r, launches=out["launches"],
                                       sweep_device=busy))
    out["ranks"] = every
    return out if r == 0 else None


def sharded_serve_phase(card_line: str, graph: str = "reddit_like@paper",
                        device: str = "cuda:0") -> dict:
    """[sharded-serve]: serving under ``Runtime.sharded(4)``, four ranks on
    ``cuda:0`` over ``gloo`` (NCCL refuses two ranks on one device), the
    front on rank 0; see the module docstring. The ranks raise on a failed
    check, and so does ``spawn``; what compares ranks is checked here."""
    from repro_torch.dist.spawn import spawn

    t0 = time.perf_counter()
    res = spawn(sharded_serve_rank, SHARDED_PARTS, device=device,
                dist_backend="gloo", args=(graph, device), timeout=600)
    label = f"{SHARDED_LABEL}; {card_line}"
    ranks = res["ranks"]
    check(all(x["launches"] == ranks[0]["launches"] for x in ranks),
          f"[sharded-serve] every rank's launches per sweep are the same: "
          f"{[x['launches'] for x in ranks]}")
    for key, p in res["parity"].items():
        log(f"[sharded-serve] (a)/(b) {key.replace('_', ' at ')} bits on "
            f"{graph}, P=4: full sweep, 64-node delta and a fresh full sweep "
            f"bit-equal to Runtime.simulated(4) on the card (rows apart "
            f"{p['rows_apart']}); delta == full; rows per site "
            f"{p['affected_rows']}, wire bytes {p['delta_bytes']} of "
            f"{p['full_bytes']}, equal; launches full / delta "
            f"{p['full_launches']} / {p['delta_launches']}")
    log(f"[sharded-serve] (c) launches per sweep, every rank: "
        f"{json.dumps(ranks[0]['launches'])} (SERVE_LAUNCHES)")
    log(f"[sharded-serve] (d) degraded: partition 2 down, a 64-node delta: "
        f"its {res['degraded']['frozen_rows']} rows frozen, staleness "
        f"{res['degraded']['staleness']}, logits equal the simulated "
        f"engine's bit for bit")
    front = res["front"]
    load, spans = front["load"], front["spans"]
    summary = dict(
        qps=load["qps"], p50_ms=load["p50_ms"], p99_ms=load["p99_ms"],
        requests=load["requests"], refreshes=load["refreshes"],
        refresh_failures=load["refresh_failures"],
        verified_rows=front["verified"], hit_rate=front["store"]["hit_rate"],
        spans_count_median_ms=spans,
        publish_delta_ms_median=sorted(front["publish_ms"])[2],
        sweep_device_ms={x["rank"]: x["sweep_device"] for x in ranks})
    log(f"[sharded-serve] (e) the front on rank 0 ({label}): "
        f"EmbeddingServer, closed loop {SERVE_SHARDED_CLIENTS} clients x "
        f"{SERVE_SHARDED_REQUESTS} requests x {SERVE_SHARDED_BATCH} ids, a "
        f"{SERVE_SHARDED_NODES}-node delta every {SERVE_SHARDED_EVERY}, "
        f"store verified; spans [count, median host ms], the publish of a "
        f"delta's rows (median of 5, host ms), each rank's one full sweep "
        f"while the other three sweep on the same card [device busy ms, of "
        f"it memcpy ms, device launches] (torch.profiler): "
        f"{json.dumps(summary)}")
    out = dict(launches=res["ranks"][0]["launches"], label=label,
               parity={k: v["rows_apart"] for k, v in res["parity"].items()},
               front=summary, seconds=time.perf_counter() - t0)
    log(f"[sharded-serve] phase done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [dlrm] and [dlrm-sharded]: DLRM at the MLPerf widths (arXiv:1906.00091)
# ---------------------------------------------------------------------------

# cut 1, one process: every table capped at 2^22 rows (25,035,512 rows,
# 12.82 GB a copy; with the gradient and Adam's moments 51.3 GB, where 2^23
# would need 94 GB); every width as published
DLRM_ROWS = 2 ** 22
DLRM_BATCH = 65_536                    # RECSYS_SHAPES' train_batch
DLRM_STEPS = 20
DLRM_TIMED = 5                         # step ms: median of steps 6..20
DLRM_LR = 1e-3
# the descent gate of LM_TRAIN_DESCENT: an SGD step of DLRM_DESCENT x loss /
# |g|^2 along step 1's gradient lowers the loss by half the prediction
DLRM_DESCENT = 1e-3
DLRM_SERVE_BATCHES = (512, 262_144)    # serve_p99, serve_bulk
DLRM_CANDIDATES = 1_000_000            # retrieval_cand
DLRM_TOP_K = 64
DLRM_PARITY_BATCH = 256
# cut 2, [dlrm-sharded]: four gloo ranks share one card, so the tables are
# capped at 2^20 rows (7,401,902 rows, 3.79 GB a copy, 15.2 GB for all four
# ranks); a global batch of 16,384 (4,096 a rank, 106,496 ids)
DLRM_SHARDED_ROWS = 2 ** 20
DLRM_SHARDED_BATCH = 16_384
DLRM_SHARDED_STEPS = 3
DLRM_SHARDED_BITS = (32, 16, 1)
# 32 bits against the single process: losses rtol 1e-5, and step 1's table
# gradient, each rank's rows, within 1e-5 x the largest. The rows after the
# Adam steps are held only to DLRM_LR x 2 a step: each rank's MLPs see a
# quarter of the batch and the dense gradients are all-reduced, so products
# round otherwise, and Adam moves an element whose gradient is cancellation
# noise by about lr either way (on the CPU, at 256-row tables and batch 64:
# 1 element of 27,520 apart at rtol 1e-5 / atol 1e-6 after one step, 15-20%
# after three, by at most 1.6e-3); the elements within rtol 1e-5 / atol
# 1e-6 are counted
DLRM_SHARDED_RTOL = 1e-5
DLRM_SHARDED_ATOL = 1e-6
DLRM_SLICE_SEED = 100                  # slice r from seed DLRM_SLICE_SEED + r


def _dlrm_sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _dlrm_launches(all_kernels: dict, path, bits=None) -> dict:
    """The launches ``DLRM_LAUNCHES`` expects of ``path``, every kernel."""
    want = {name: 0 for name in all_kernels}
    want.update(zip(DLRM_KERNELS, DLRM_LAUNCHES[(path, bits)]))
    return want


def dlrm_parity(dev: torch.device) -> dict:
    """The reduced config and the published widths with 26 tables of 64
    rows, the same weights on the card and on the CPU: logits (batch
    ``DLRM_PARITY_BATCH``) within rtol 1e-5 and atol ``ZOO_PARITY_ATOL``,
    and the losses of two Adam steps on one batch (the second after one
    update) within the same. A control runs the card's products in TF32 and
    must fall outside the logits' gate."""
    from repro_torch import configs
    from repro_torch.data.pipeline import criteo_stream
    from repro_torch.models.convert import (dlrm_params_from_numpy,
                                            dlrm_params_to_numpy)
    from repro_torch.models.recsys import dlrm as D
    from repro_torch.train import optimizer as optlib

    spec = configs.get("dlrm-mlperf")
    out = {}
    for tag, cfg in (("reduced", spec.reduced()),
                     ("widths", dataclasses.replace(
                         spec.config(), table_sizes=(64,) * 26))):
        tree, table = dlrm_params_to_numpy(*D.init_params(cfg, SEED))
        batch = next(criteo_stream(cfg, DLRM_PARITY_BATCH, SEED))
        res = {}
        for where, tf32 in ((dev.type, False), ("cpu", False),
                            (dev.type, True)):
            if tf32 and dev.type != "cuda":
                continue
            dp, tb = dlrm_params_from_numpy(tree, table, where)
            dx, ids, lb = (torch.from_numpy(x).to(where) for x in batch)
            was = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                with torch.no_grad():
                    logits = D.dlrm_forward(dp, tb, dx, ids, cfg).cpu()
                opt = optlib.adam(DLRM_LR)
                state = (dp, tb, opt.init(dp), opt.init(tb),
                         torch.zeros((), dtype=torch.int32, device=where))
                step = D.make_train_step(cfg, opt)
                losses = []
                for _ in range(2):
                    state, loss = step(state, dx, ids, lb)
                    losses.append(float(loss))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = was
            res[where + "_tf32" * tf32] = (logits, losses)
        want, want_l = res["cpu"]
        got, got_l = res[dev.type]
        err = float((got - want).abs().max())
        loss_err = max(abs(a - b) for a, b in zip(got_l, want_l))
        check(torch.allclose(got, want, rtol=1e-5, atol=ZOO_PARITY_ATOL),
              f"[dlrm] {tag}: logits card vs CPU (max abs err {err})")
        check(all(abs(a - b) <= ZOO_PARITY_ATOL + 1e-5 * abs(b)
                  for a, b in zip(got_l, want_l)),
              f"[dlrm] {tag}: Adam steps' losses card {got_l} vs CPU "
              f"{want_l}")
        out[tag] = dict(logits_max_abs_err=err, losses=got_l,
                        cpu_losses=want_l, loss_max_abs_err=loss_err,
                        largest_logit=float(want.abs().max()))
        if "cuda_tf32" in res:
            tf = res["cuda_tf32"][0]
            out[tag]["tf32_logits_max_abs_err"] = float(
                (tf - want).abs().max())
            check(not torch.allclose(tf, want, rtol=1e-5,
                                     atol=ZOO_PARITY_ATOL),
                  f"[dlrm] {tag}: the TF32 control passes the gate (max abs "
                  f"err {out[tag]['tf32_logits_max_abs_err']})")
        log(f"[dlrm] parity {tag} (batch {DLRM_PARITY_BATCH}): "
            f"{json.dumps(out[tag])} (rtol 1e-5, atol {ZOO_PARITY_ATOL:g})")
    return out


def dlrm_phase(all_kernels: dict, device: str = "cuda", rows: int = DLRM_ROWS,
               batch: int = DLRM_BATCH,
               serve_batches: tuple = DLRM_SERVE_BATCHES,
               candidates: int = DLRM_CANDIDATES) -> dict:
    """[dlrm]: DLRM at the MLPerf widths, tables capped at ``rows``, in one
    process. (a) a batch's id plan (the table gradient's CSR), host ms;
    (b) step 1's gradient: launches exact, the descent gate
    (``DLRM_DESCENT``), and its SpMM call, recorded, bit-equal to the plain
    version and to itself on a second call, timed beside its bound,
    ``torch.sparse.mm`` and ``index_add_``; (c) ``DLRM_STEPS`` Adam steps
    through ``launch.train.train_dlrm`` on ``criteo_stream`` and the
    ``Prefetcher`` (finite losses, exact launches every step, step ms,
    samples/s, peak GB) and (d) one profiled step; (e) ``make_serve_step``
    at ``serve_batches`` and (f) ``make_retrieval_step`` over
    ``candidates`` distinct field-0 candidates, its top ``DLRM_TOP_K``
    against a full sort of the same scores; (g) ``dlrm_parity``. On the
    CPU (a dry run at small sizes) no kernel launches and nothing is timed
    on the device."""
    import argparse
    import io

    from repro_torch import configs
    from repro_torch.data.pipeline import criteo_stream
    from repro_torch.dist.runtime import resolve_device
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    from repro_torch.launch.train import train_dlrm
    from repro_torch.models.recsys import dlrm as D
    from repro_torch.train import optimizer as optlib

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    cfg = D.capped(configs.get("dlrm-mlperf").config(), rows)

    def counts():
        return {name: meta["k"].launches for name, meta in all_kernels.items()}

    def zero():
        for meta in all_kernels.values():
            meta["k"].launches = 0

    def want(path, bits=None):
        w = _dlrm_launches(all_kernels, path, bits)
        return w if on_card else {k: 0 for k in w}

    def to_dev(*xs):
        return tuple(torch.from_numpy(x).to(dev) for x in xs)

    out = dict(rows=cfg.total_rows, table_gb=cfg.total_rows * 512 / 1e9,
               batch=batch, launches={},
               allocated_before_gb=torch.cuda.memory_allocated() / 1e9
               if on_card else None)
    log(f"[dlrm] ({out['allocated_before_gb']} GB allocated before the "
        f"phase) dlrm-mlperf, tables capped at {rows} rows: "
        f"{cfg.total_rows} rows x {cfg.embed_dim} ({out['table_gb']:.2f} GB "
        f"float32, x4 with the gradient and Adam's moments), bottom MLP "
        f"{[cfg.n_dense, *cfg.bot_mlp]}, top {[cfg.interaction_dim, *cfg.top_mlp]}"
        f", batch {batch} ({batch * cfg.total_ids_per_sample} ids)")

    # (a) the id plan of one batch, built on the host
    host = next(criteo_stream(cfg, batch, SEED))
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        plan = D.id_plan(host[1])
        ms.append((time.perf_counter() - t0) * 1e3)
    deg = np.diff(plan.csr.row_ptr.numpy())
    out["id_plan"] = dict(host_ms=float(np.median(ms)),
                          unique_rows=int(plan.rows.numel()),
                          ids=int(host[1].size), largest_row=int(deg.max()),
                          id0_share=float(deg.max() / batch),
                          split_rows=int(plan.csr.long_rows.numel()),
                          partials=plan.csr.n_partials)
    log(f"[dlrm] (a) id plan of one batch (host, median of 5): "
        f"{json.dumps(out['id_plan'])}")

    # (b) step 1's gradient with the kernels; descent; its SpMM call
    dp, tb = D.init_params(cfg, SEED, dev)
    dense, ids, label = to_dev(*host)
    dplan = plan.to(dev)
    calls = []
    zero()
    with recording(D, "spmm", calls):
        loss_k, gd, gt = D.loss_and_grads(dp, tb, dense, ids, label, cfg,
                                          plan=dplan)
    _dlrm_sync(dev)
    check(counts() == want("train"), f"[dlrm] step 1's gradient launched "
          f"{counts()}, expected {want('train')}")
    touched = dplan.rows
    check(int(torch.count_nonzero(gt)) <= touched.numel() * cfg.embed_dim,
          "[dlrm] the table's gradient is zero outside the touched rows")
    gsq = sum(float(g.double().square().sum())
              for g in optlib.tree_leaves(gd))
    gsq += float(gt[touched].double().square().sum())
    eta = DLRM_DESCENT * float(loss_k) / gsq
    saved = tb[touched].clone()
    tb[touched] -= eta * gt[touched]
    stepped = optlib.tree_map(lambda p_, g_: p_ - eta * g_, dp, gd)
    with torch.no_grad():
        loss_s = float(D.bce_loss(D.dlrm_forward(stepped, tb, dense, ids,
                                                 cfg), label))
    tb[touched] = saved
    descent = dict(loss=float(loss_k), sgd_lr=eta, predicted_drop=eta * gsq,
                   drop=float(loss_k) - loss_s)
    check(descent["drop"] >= 0.5 * descent["predicted_drop"],
          f"[dlrm] a step of {eta:.3g} along step 1's gradient lowers the "
          f"loss by at least half the first-order prediction ({descent})")
    out["descent"] = descent
    log(f"[dlrm] (b) step 1's gradient: {json.dumps(descent)}")
    del gd, gt, stepped, saved, dp, tb
    g, csr = calls[0][:2]
    del calls
    d = g.shape[1]
    n_rows, nnz = csr.n_rows, csr.nnz
    sb, so = bound(g.numel() * 4 + (n_rows + 1) * 4 + nnz * 8
                   + n_rows * d * 4, 2 * nnz * d)
    spmm = dict(shape=[n_rows, csr.n_cols, d, nnz],
                split_rows=int(csr.long_rows.numel()),
                partials=csr.n_partials, bound_ms=sb, bound_by=so)
    if on_card:
        out_k = sops.spmm(g, csr)
        err = float((out_k - sref.spmm_ref(g, csr)).abs().max())
        check(same_bits(out_k, sref.spmm_ref(g, csr)),
              f"[dlrm] the step's spmm_csr call: bit-equal to the plain "
              f"version (max abs err {err})")
        check(same_bits(out_k, sops.spmm(g, csr)),
              "[dlrm] the step's spmm_csr call: same bits on a second call")
        with warnings.catch_warnings():   # sparse CSR is "beta" in PyTorch
            warnings.simplefilter("ignore")
            sparse = torch.sparse_csr_tensor(csr.row_ptr, csr.col, csr.w,
                                             size=(n_rows, csr.n_cols))
        inv = torch.empty(csr.n_cols, dtype=torch.int64, device=dev)
        inv[csr.col.long()] = torch.repeat_interleave(
            torch.arange(n_rows, device=dev),
            torch.diff(csr.row_ptr).long())
        spmm.update(
            max_abs_err=err, bit_equal=True,
            ms=cuda_ms(lambda: sops.spmm(g, csr)),
            plain_ms=cuda_ms(lambda: sref.spmm_ref(g, csr), iters=2,
                             warmup=1),
            library_ms=cuda_ms(lambda: torch.sparse.mm(sparse, g)),
            library="torch.sparse.mm",
            index_add_ms=cuda_ms(lambda: torch.zeros(
                (n_rows, d), device=dev).index_add_(0, inv, g)))
        del out_k, sparse, inv
    out["spmm"] = spmm
    log(f"[dlrm] (b) the step's spmm_csr call (the table's gradient over "
        f"the transposed id CSR): {json.dumps(spmm)}")
    del g, csr, dense, ids, label
    if on_card:
        torch.cuda.empty_cache()

    # (c) training through the launcher's loop
    args = argparse.Namespace(arch="dlrm-mlperf", reduced=False,
                              max_ind_range=rows, batch=batch,
                              steps=DLRM_STEPS, lr=DLRM_LR, seed=SEED,
                              log_every=1, device=str(dev))
    step_ms, step_launches = [], []
    zero()
    prev = [counts(), time.perf_counter()]

    def on_step(i, loss):
        float(loss)
        now, c = time.perf_counter(), counts()
        step_ms.append((now - prev[1]) * 1e3)
        step_launches.append({k: c[k] - prev[0][k] for k in c})
        prev[:] = [c, now]

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        losses = train_dlrm(args, on_step)
    train_s = time.perf_counter() - t0
    for line in printed.getvalue().splitlines():
        log(f"[dlrm] (c) {line}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    check(len(losses) == DLRM_STEPS and all(np.isfinite(losses)),
          f"[dlrm] {DLRM_STEPS} finite losses ({losses})")
    for i, got in enumerate(step_launches):
        check(got == want("train"), f"[dlrm] step {i + 1} launched {got}, "
              f"expected {want('train')}")
    med = float(np.median(step_ms[DLRM_TIMED:]))
    out["train"] = dict(
        losses=losses, step_ms=step_ms, median_step_ms=med,
        samples_per_s=batch / med * 1e3, peak_gb=peak, seconds=train_s,
        step1_equals_gradient_run=losses[0] == descent["loss"])
    out["launches"]["dlrm_train_step"] = step_launches[-1]
    log(f"[dlrm] (c) {DLRM_STEPS} Adam {DLRM_LR} steps through train_dlrm: "
        f"{json.dumps(out['train'])} (step ms: host clock ending in "
        f"float(loss), median of steps {DLRM_TIMED + 1}..{DLRM_STEPS})")
    if on_card:
        torch.cuda.empty_cache()

    # (d) one profiled step, split by group
    dp, tb = D.init_params(cfg, SEED, dev)
    opt = optlib.adam(DLRM_LR)
    state = (dp, tb, opt.init(dp), opt.init(tb),
             torch.zeros((), dtype=torch.int32, device=dev))
    step = D.make_train_step(cfg, opt)
    dense, ids, label = to_dev(*host)
    state, _ = step(state, dense, ids, label, None, dplan)
    if on_card:
        marks = {"dlrm_gather": None, "dlrm_table_adam": None}
        with marked(D, "embedding_bag", "dlrm_gather"), \
                marked(D, "_update_table", "dlrm_table_adam"):
            (state, _), wall, busy, groups, _ = profile_device(
                lambda: step(state, dense, ids, label, None, dplan),
                f"dlrm: one training step (batch {batch})", marks)
        split = dict(host_ms=wall, device_busy_ms=busy, busy_share=busy / wall,
                     cublas_ms=groups["gemm"], spmm_ms=groups["spmm"],
                     table_adam_ms=marks["dlrm_table_adam"]["fwd_ms"],
                     gather_ms=marks["dlrm_gather"]["fwd_ms"],
                     table_grad_ms=marks["dlrm_gather"]["bwd_ms"])
        split["table_grad_rest_ms"] = split["table_grad_ms"] - split["spmm_ms"]
        split["rest_ms"] = busy - split["cublas_ms"] - split["table_adam_ms"] \
            - split["gather_ms"] - split["table_grad_ms"]
        out["profile"] = split
        log(f"[dlrm] (d) one profiled step: {json.dumps(split)} (gather: the "
            f"table's index_select; table_grad: its backward, the SpMM, the "
            f"zero gradient and the rows' index_copy_)")
    dp, tb = state[0], state[1]
    del state, opt, step, dense, ids, label, dplan
    if on_card:
        torch.cuda.empty_cache()

    # (e) serving
    serve = D.make_serve_step(cfg)
    out["serve"] = {}
    for b in serve_batches:
        dx, fid, _ = to_dev(*next(criteo_stream(cfg, b, SEED + 1)))
        zero()
        ctr = serve(dp, tb, dx, fid)
        _dlrm_sync(dev)
        check(counts() == want("serve"), f"[dlrm] serve {b} launched "
              f"{counts()}")
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            ctr = serve(dp, tb, dx, fid)
            _dlrm_sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        check(ctr.shape == (b,) and bool(torch.isfinite(ctr).all())
              and bool(((ctr >= 0) & (ctr <= 1)).all()),
              f"[dlrm] serve {b}: CTR of shape ({b},) in [0, 1]")
        out["serve"][b] = dict(median_ms=float(np.median(ms)),
                               mean_ctr=float(ctr.mean()))
    out["launches"]["dlrm_serve"] = counts()
    log(f"[dlrm] (e) make_serve_step, median ms of 5 (host clock ending in "
        f"a sync): {json.dumps(out['serve'])}")

    # (f) retrieval over distinct field-0 candidates
    offs = cfg.row_offsets
    n0 = int(offs[1] - offs[0])
    cand = torch.from_numpy(np.random.default_rng(SEED).permutation(n0)[
        :candidates].astype(np.int32) + int(offs[0])).to(dev)
    qx, qid, _ = to_dev(*next(criteo_stream(cfg, 1, SEED + 2)))
    ret = D.make_retrieval_step(cfg, None, top_k=DLRM_TOP_K)
    zero()
    v, got = ret(dp, tb, qx, qid, cand)
    _dlrm_sync(dev)
    check(counts() == want("retrieval"), f"[dlrm] retrieval launched "
          f"{counts()}")
    out["launches"]["dlrm_retrieval"] = counts()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        v, got = ret(dp, tb, qx, qid, cand)
        _dlrm_sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        scores = D.retrieval_scores(dp, tb, qx, qid, cand, cfg)
    full, order = torch.sort(scores, descending=True, stable=True)
    k = DLRM_TOP_K
    check(bool((v[1:] <= v[:-1]).all()), "[dlrm] retrieval values sorted")
    check(same_bits(v, full[:k]), "[dlrm] retrieval values == the top "
          f"{k} of a full sort of the same scores")
    strict = full[:k] > full[k]                # ties at the cut may swap
    check(set(got[strict].tolist()) == set(cand[order[:k]][strict].tolist())
          and bool(((got >= offs[0]) & (got < offs[1])).all()),
          "[dlrm] retrieval ids == the full sort's, in field 0's range")
    out["retrieval"] = dict(candidates=candidates, top_k=k,
                            median_ms=float(np.median(ms)),
                            ties_at_cut=int(k - int(strict.sum())))
    log(f"[dlrm] (f) make_retrieval_step, 1 query x {candidates} distinct "
        f"field-0 candidates, top {k} (median ms of 5, host clock ending in "
        f"a sync; values and ids == a full sort's): "
        f"{json.dumps(out['retrieval'])}")
    del dp, tb, scores, full, order, cand, v, got
    if on_card:
        torch.cuda.empty_cache()

    # (g) card against the CPU
    out["parity"] = dlrm_parity(dev)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[dlrm] phase done in {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def timed_collectives(events: list, dev: torch.device):
    """Every ``torch.distributed`` collective DLRM's step calls (all-gather,
    all-to-all, all-reduce) appended to ``events``: the op, the sent
    tensor's dtype, shape and bytes, and its ms on the host clock between
    two syncs. Restored on exit."""
    import torch.distributed as dist
    sent = {"all_gather": 1, "all_to_all_single": 1, "all_reduce": 0}
    real = {name: getattr(dist, name) for name in sent}

    def wrap(name):
        def fn(*a, **k):
            t = a[sent[name]]
            _dlrm_sync(dev)
            t0 = time.perf_counter()
            res = real[name](*a, **k)
            _dlrm_sync(dev)
            events.append(dict(op=name,
                               dtype=str(t.dtype).removeprefix("torch."),
                               shape=list(t.shape),
                               bytes=t.numel() * t.element_size(),
                               ms=(time.perf_counter() - t0) * 1e3))
            return res
        return fn
    for name in sent:
        setattr(dist, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _dlrm_sharded_cfg(rows: int, bits=None):
    from repro_torch import configs
    from repro_torch.models.recsys import dlrm as D
    return dataclasses.replace(
        D.capped(configs.get("dlrm-mlperf").config(), rows),
        quantize_collective_bits=None if bits == 32 else bits)


def _dlrm_slice(cfg, r: int, dev: torch.device) -> torch.Tensor:
    """Rank ``r``'s rows of the table, from its own seeded generator."""
    from repro_torch.models.recsys import dlrm as D
    return D.init_table(cfg, SHARDED_PARTS, torch.Generator(dev).manual_seed(
        DLRM_SLICE_SEED + r), shard=True)


def dlrm_sharded_single(dev: torch.device, rows: int, batch: int) -> dict:
    """The single-process run [dlrm-sharded] is held to: the concatenation
    of the four slices, ``DLRM_SHARDED_STEPS`` Adam steps at 32 bits.
    Returns its losses, step 1's table gradient over the rows that step
    touched, the rows any step touched and their final values."""
    from repro_torch.data.pipeline import criteo_stream
    from repro_torch.models.recsys import dlrm as D
    from repro_torch.train import optimizer as optlib

    cfg = _dlrm_sharded_cfg(rows)
    dp = D.init_dense_params(cfg, torch.Generator().manual_seed(SEED), dev)
    tb = torch.cat([_dlrm_slice(cfg, r, dev) for r in range(SHARDED_PARTS)])
    opt = optlib.adam(DLRM_LR)
    state = (dp, tb, opt.init(dp), opt.init(tb),
             torch.zeros((), dtype=torch.int32, device=dev))
    step = D.make_train_step(cfg, opt)
    losses, ids_seen, grad = [], [], None
    for dx, ids, lb in criteo_stream(cfg, batch, SEED,
                                     n_batches=DLRM_SHARDED_STEPS):
        args = tuple(torch.from_numpy(x).to(dev) for x in (dx, ids, lb))
        plan = D.id_plan(ids).to(dev)
        if grad is None:
            gt = D.loss_and_grads(dp, tb, *args, cfg, plan=plan)[2]
            grad = dict(rows=plan.rows.cpu().numpy(),
                        values=gt[plan.rows].cpu().numpy())
            del gt
        state, loss = step(state, *args, None, plan)
        losses.append(float(loss))
        ids_seen.append(ids)
    touched = np.unique(np.concatenate(ids_seen)).astype(np.int64)
    return dict(losses=losses, touched=touched, total_rows=cfg.total_rows,
                grad=grad, rows=state[1][torch.from_numpy(touched).to(dev)]
                .cpu().numpy())


def dlrm_sharded_rank(device: str, single: dict, rows: int,
                      batch: int) -> list:
    """One rank of [dlrm-sharded], inside ``dist.spawn``: its slice of the
    table, its quarter of each global batch, ``DLRM_SHARDED_STEPS`` Adam
    steps at each of ``DLRM_SHARDED_BITS``. Raises on a failed check of its
    own; returns every rank's results."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import criteo_stream
    from repro_torch.dist.runtime import Runtime
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.models.recsys import dlrm as D
    from repro_torch.train import optimizer as optlib

    all_kernels = kernel_table()
    rt = Runtime.sharded(SHARDED_PARTS, device=device)
    r, dev, be = rt.rank, rt.device, rt.backend
    on_card = dev.type == "cuda"
    b_local = batch // SHARDED_PARTS
    out = dict(rank=r, device=str(dev))

    def counts():
        return {name: meta["k"].launches for name, meta in all_kernels.items()}

    for bits in DLRM_SHARDED_BITS:
        cfg = _dlrm_sharded_cfg(rows, bits)
        dp = D.init_dense_params(cfg, torch.Generator().manual_seed(SEED),
                                 dev)
        tb = _dlrm_slice(cfg, r, dev)
        rpd = tb.shape[0]
        opt = optlib.adam(DLRM_LR)
        state = (dp, tb, opt.init(dp), opt.init(tb),
                 torch.zeros((), dtype=torch.int32, device=dev))
        step = D.make_train_step(cfg, opt, be)
        want = _dlrm_launches(all_kernels, "train_sharded", bits)
        if not on_card:
            want = {k: 0 for k in want}
        run = dict(losses=[], step_ms=[], launches=[])
        qcalls, dcalls = [], []
        for i, (dx, ids, lb) in enumerate(criteo_stream(
                cfg, batch, SEED, n_batches=DLRM_SHARDED_STEPS)):
            sl = slice(r * b_local, (r + 1) * b_local)
            dx, ids, lb = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                           for x in (dx[sl], ids.reshape(batch, -1)[sl]
                                     .reshape(-1), lb[sl]))
            if bits == 32 and i == 0:
                # step 1's table gradient, this rank's rows
                gt = D.loss_and_grads(dp, tb, dx, ids, lb, cfg, be)[2]
                g = single["grad"]
                mine = (g["rows"] >= r * rpd) & (g["rows"] < (r + 1) * rpd)
                got_g = gt[torch.from_numpy(g["rows"][mine] - r * rpd)
                           .to(dev)].cpu().numpy()
                err = float(np.abs(got_g - g["values"][mine]).max())
                top = float(np.abs(g["values"]).max())
                run["grad_rows"] = int(mine.sum())
                run["grad_max_abs_err_over_largest"] = err / top
                check(err <= DLRM_SHARDED_RTOL * top,
                      f"[dlrm-sharded] rank {r}: step 1's table gradient on "
                      f"its {int(mine.sum())} rows within "
                      f"{DLRM_SHARDED_RTOL} x the largest of the single "
                      f"process's (max abs err {err}, largest {top})")
                del gt
            events = []
            last = i == DLRM_SHARDED_STEPS - 1
            with contextlib.ExitStack() as stack:
                if last:
                    stack.enter_context(timed_collectives(events, dev))
                    stack.enter_context(recording(
                        qops, "quantize_pack_rows", qcalls))
                    stack.enter_context(recording(
                        qops, "dequantize_rows", dcalls))
                for meta in all_kernels.values():
                    meta["k"].launches = 0
                _dlrm_sync(dev)
                t0 = time.perf_counter()
                state, loss = step(state, dx, ids, lb,
                                   D.step_generator(SEED, i, dev))
                run["losses"].append(float(loss))
                run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            got = counts()
            check(got == want, f"[dlrm-sharded] rank {r} {bits} bits step "
                  f"{i + 1} launched {got}, expected {want}")
            run["launches"].append(got)
        run["collectives"] = events
        check(all(np.isfinite(run["losses"])), f"[dlrm-sharded] rank {r} "
              f"{bits} bits: finite losses {run['losses']}")
        if on_card:
            for h, u, b, sd in qcalls:
                kern = qops.quantize_pack_rows(h, u, b, sd)
                plain = qref.quantize_pack_ref(h, u, b)
                plain = (plain[0], plain[1].to(sd), plain[2].to(sd))
                check(all(same_bits(a, c) for a, c in zip(kern, plain)),
                      f"[dlrm-sharded] rank {r} {bits} bits: the step's "
                      f"quantize call {tuple(h.shape)} bit-equal to the "
                      f"plain version")
            for pk, s_, z_, b, d in dcalls:
                check(same_bits(qops.dequantize_rows(pk, s_, z_, b, d),
                                qref.unpack_dequantize_ref(
                                    pk, s_.float(), z_.float(), b, d)),
                      f"[dlrm-sharded] rank {r} {bits} bits: the step's "
                      f"dequantize call {tuple(pk.shape)} bit-equal to the "
                      f"plain version")
        run["quantize_calls_checked"] = len(qcalls) if on_card else 0
        run["dequantize_calls_checked"] = len(dcalls) if on_card else 0
        del qcalls, dcalls
        if bits == 32:
            lo = r * rpd
            mine = (single["touched"] >= lo) & (single["touched"] < lo + rpd)
            local = torch.from_numpy(single["touched"][mine] - lo).to(dev)
            got_rows = state[1][local].cpu().numpy()
            want_rows = single["rows"][mine]
            diff = np.abs(got_rows - want_rows)
            run["touched_rows"] = int(mine.sum())
            run["rows_max_abs_diff"] = float(diff.max()) if diff.size else 0.0
            run["elements_apart"] = int((~np.isclose(
                got_rows, want_rows, rtol=DLRM_SHARDED_RTOL,
                atol=DLRM_SHARDED_ATOL)).sum())
            run["elements"] = int(diff.size)
            check(run["rows_max_abs_diff"]
                  <= 2 * DLRM_LR * DLRM_SHARDED_STEPS,
                  f"[dlrm-sharded] rank {r}: its {int(mine.sum())} touched "
                  f"rows within {2 * DLRM_LR} a step of the single process's "
                  f"(largest difference {run['rows_max_abs_diff']})")
            check(np.allclose(run["losses"], single["losses"],
                              rtol=DLRM_SHARDED_RTOL, atol=0),
                  f"[dlrm-sharded] rank {r}: 32-bit losses {run['losses']} "
                  f"vs the single process's {single['losses']}")
        out[bits] = run
        del state, dp, tb, opt, step
        if on_card:
            torch.cuda.empty_cache()
    every = [None] * SHARDED_PARTS
    dist.all_gather_object(every, out)
    return every


def dlrm_sharded_phase(card_line: str, device: str = "cuda:0",
                       rows: int = DLRM_SHARDED_ROWS,
                       batch: int = DLRM_SHARDED_BATCH) -> dict:
    """[dlrm-sharded]: DLRM under ``Runtime.sharded``, four ranks on
    ``device`` over ``gloo``, tables capped at ``rows`` and a global batch of
    ``batch``, spawned as [sharded] spawns them. The single process on the
    concatenated table runs first, here; the ranks hold their 32-bit run to
    it (losses, touched rows) and check their launches and, at 1 bit, the
    step's quantize and dequantize calls against the plain versions."""
    from repro_torch.dist.runtime import resolve_device
    from repro_torch.dist.spawn import spawn

    t0 = time.perf_counter()
    dev = resolve_device(device)
    single = dlrm_sharded_single(dev, rows, batch)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[dlrm-sharded] single process on the four slices concatenated "
        f"({single['total_rows']} rows, global batch {batch}): losses "
        f"{single['losses']}, {single['touched'].size} rows touched")
    ranks = spawn(dlrm_sharded_rank, SHARDED_PARTS, device=device,
                  dist_backend="gloo", args=(device, single, rows, batch),
                  timeout=600)
    label = f"{SHARDED_LABEL}; {card_line}"
    out: dict = dict(launches={}, label=label, single_losses=single["losses"])
    for bits in DLRM_SHARDED_BITS:
        runs = [x[bits] for x in ranks]
        check(all(x["losses"] == runs[0]["losses"] for x in runs),
              f"[dlrm-sharded] {bits} bits: every rank's losses are the same")
        res = dict(losses=runs[0]["losses"],
                   step_ms={x["rank"]: x[bits]["step_ms"] for x in ranks},
                   quantize_calls_checked=sum(
                       x["quantize_calls_checked"] for x in runs),
                   dequantize_calls_checked=sum(
                       x["dequantize_calls_checked"] for x in runs),
                   collectives=[dict(e, ms=[x["collectives"][j]["ms"]
                                            for x in runs])
                                for j, e in enumerate(runs[0]["collectives"])])
        if bits == 32:
            res.update(
                loss_max_rel_err=max(abs(a - b) / abs(b) for a, b in zip(
                    runs[0]["losses"], single["losses"])),
                grad_rows=[x["grad_rows"] for x in runs],
                grad_max_abs_err_over_largest=max(
                    x["grad_max_abs_err_over_largest"] for x in runs),
                touched_rows=[x["touched_rows"] for x in runs],
                rows_max_abs_diff=max(x["rows_max_abs_diff"] for x in runs),
                elements_apart=sum(x["elements_apart"] for x in runs),
                elements=sum(x["elements"] for x in runs))
        out[bits] = res
        out["launches"][f"dlrm_train_sharded_{bits}_step"] = \
            runs[0]["launches"][-1]
        log(f"[dlrm-sharded] {bits} bits, {DLRM_SHARDED_STEPS} Adam "
            f"{DLRM_LR} steps on every rank: {json.dumps(res)} (launches "
            f"exact on every rank; collectives of the last step in call "
            f"order: the bytes of the tensor a rank sends, ms on the host "
            f"clock between syncs per rank, {label})")
    wire = {bits: sum(e["bytes"] for e in out[bits]["collectives"])
            for bits in DLRM_SHARDED_BITS}
    out["wire_bytes_per_step"] = wire
    out["seconds"] = time.perf_counter() - t0
    log(f"[dlrm-sharded] bytes a rank sends a step, by bits: "
        f"{json.dumps(wire)}; phase done in {out['seconds']:.1f} s")
    return out


# [sampled]: the minibatch_lg cell (configs/base.py GNN_SHAPES): 1,024 seeds
# a batch, fan-outs (15, 10), on a Reddit-sized stand-in of reddit_like's
# TargetStats (232,965 nodes, average degree 492, 602 features, 41
# classes; its paper tier's p_in 0.85 and gamma 0.8), GraphSAGE 256x2 (the
# paper's SAGE_SPEC), P = 4 on Runtime.simulated, Adam 1e-2
SAMPLED_BATCH = 1024
SAMPLED_FANOUTS = (15, 10)
SAMPLED_PARTS = 4
SAMPLED_BATCHES = 20
SAMPLED_LR = 1e-2
SAMPLED_GRAPH = dict(n_nodes=232_965, avg_degree=492, d_feat=602,
                     n_classes=41, p_in=0.85, gamma=0.8)
SAMPLED_PROFILED = 10           # the batch whose step is profiled
SAMPLED_PARITY_RTOL = 1e-5      # the first vanilla loss, card against CPU
SAMPLED_DESCENT = 0.9           # mean loss of batches 16-20 < 0.9 x batch 1's


def sampled_batches(sampler, n_batches: int, batch_nodes: int, parts: int):
    """The host half of a sampled step, one batch at a time: sample
    ``batch_nodes`` seeds' neighbourhood, add self-loops, partition it into
    ``parts`` (``graph.partition.partition_graph``, the Table-1 loop's
    ``formats.add_self_loops`` + ``partition_graph``) and build its block
    on the host (``blocks.build_block``: the CSRs and the SpMM's work
    plans). Yields ``(block, x, y, train_mask, info)``; ``info`` holds the
    host ms of each part and the batch's sizes."""
    from repro_torch.graph import formats
    from repro_torch.graph.partition import partition_graph
    from repro_torch.models.gnn import blocks as B

    for _ in range(n_batches):
        t0 = time.perf_counter()
        sub = sampler.sample(batch_nodes=batch_nodes)
        t1 = time.perf_counter()
        g = formats.Graph(sub.n_nodes,
                          formats.add_self_loops(sub.edge_index, sub.n_nodes),
                          sub.x, sub.y, sub.train_mask, sub.val_mask,
                          sub.test_mask, n_classes=sub.n_classes)
        pg = partition_graph(g, parts)
        t2 = time.perf_counter()
        block = B.build_block(pg, "cpu")
        t3 = time.perf_counter()
        info = dict(nodes=sub.n_nodes, edges=sub.n_edges,
                    block_edges=block.csr.nnz,
                    halo_rows=parts * int(pg.plan.halo_rows),
                    real_halo_rows=int(pg.plan.real_rows()),
                    sample_ms=(t1 - t0) * 1e3, partition_ms=(t2 - t1) * 1e3,
                    block_ms=(t3 - t2) * 1e3)
        yield block, pg.x, pg.y, pg.train_mask, info


def sampled_train(sampler, model, cfg, opt, n_batches: int, *,
                  batch_nodes: int = SAMPLED_BATCH,
                  parts: int = SAMPLED_PARTS, seed: int = SEED,
                  device=None, launches=None, hook=None) -> dict:
    """Sampled training, the reference's Table-1 loop
    (``benchmarks/table1_sampling.py``) at any shape, on
    ``Runtime.simulated(parts, device)``: for each of ``n_batches``
    batches the ``Prefetcher``'s worker does the host half
    (:func:`sampled_batches`: sample, self-loops, partition, block) and
    copies the batch to the device; the main thread takes one step of
    ``make_gnn_steps(model, cfg, opt)``'s synchronous step, the parameters
    and the optimizer's state carried across batches and the halo caches
    ``HaloState.zeros`` of the new plan (the noise key ``(seed, batch)``).
    Only ``vanilla`` and Sylvie-S run: Sylvie-A's stale halos belong to one
    plan, and every batch has its own.

    ``launches`` (``None``, or a function returning counts) is read before
    and after each step, whose difference is recorded; ``hook(b, run)``
    runs batch ``b``'s step ``run()`` (default: ``run()``), so a caller can
    profile one. Returns the losses, the last parameters (on the CPU), each
    batch's ``info``, its main-thread wait on the queue, its step's host ms
    (ending in ``float(loss)``) and, on CUDA, device ms (CUDA events around
    the step), and the launches."""
    from repro_torch.core.staleness import HaloState
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.dist.runtime import Runtime
    from repro_torch.train import optimizer as optlib
    from repro_torch.train.gnn_step import GNNTrainState, make_gnn_steps

    if cfg.mode not in ("vanilla", "sync"):
        raise ValueError(
            f"sampled training runs vanilla or Sylvie-S, not {cfg.mode!r}: "
            "stale halos belong to one plan, and every batch has its own")
    rt = Runtime.simulated(parts, device=device)
    dev = rt.device
    cuda = dev.type == "cuda"
    dims = model.comm_dims()
    step, _, _ = make_gnn_steps(model, cfg, opt, backend=rt.backend)
    batches = Prefetcher(sampled_batches(sampler, n_batches, batch_nodes,
                                         parts), depth=2, device=dev)
    state = None
    out = dict(losses=[], info=[], wait_ms=[], step_ms=[], device_ms=[],
               launches=[])
    for b in range(n_batches):
        t0 = time.perf_counter()
        block, x, y, mask, info = next(batches)
        t1 = time.perf_counter()
        if state is None:
            state = GNNTrainState.create(model.param_tree(), opt, block.plan,
                                         dims, device=dev)
        else:
            state = dataclasses.replace(state, halo=HaloState.zeros(
                block.plan, dims, device=dev))
        before = launches() if launches else None
        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"] \
            if cuda else None

        def run(state=state, block=block, x=x, y=y, mask=mask, b=b):
            if ev:
                ev[0].record()
            new, loss = step(state, block, x, y, mask, (seed, b))
            if ev:
                ev[1].record()
            return new, float(loss)

        state, loss = hook(b, run) if hook else run()
        t2 = time.perf_counter()
        out["losses"].append(loss)
        out["info"].append(info)
        out["wait_ms"].append((t1 - t0) * 1e3)
        out["step_ms"].append((t2 - t1) * 1e3)
        if ev:
            out["device_ms"].append(ev[0].elapsed_time(ev[1]))
        if launches:
            out["launches"].append(tuple(a - c for a, c in
                                         zip(launches(), before)))
    check(next(batches, None) is None, "the sampler yielded more batches")
    out["params"] = [p.detach().cpu() for p in
                     optlib.tree_leaves(state.params)]
    return out


def fresh_sampler(sampler, seed: int = SEED):
    """``sampler`` (its graph and CSR shared) with a new generator from
    ``seed``: the same batches again, without rebuilding the CSR."""
    import copy
    s = copy.copy(sampler)
    s.rng = np.random.default_rng(seed)
    return s


def sampled_phase(all_kernels: dict, device: str = "cuda",
                  graph: dict | None = None,
                  n_batches: int = SAMPLED_BATCHES,
                  batch_nodes: int = SAMPLED_BATCH,
                  fanouts: tuple = SAMPLED_FANOUTS) -> dict:
    """[sampled]: the ``minibatch_lg`` cell. One Reddit-sized stand-in
    (``SAMPLED_GRAPH``, ``synthetic.powerlaw_community``, seed 0; its host
    seconds and peak RSS logged) and its ``NeighborSampler``; GraphSAGE
    256x2 trained by :func:`sampled_train`, ``n_batches`` batches of
    ``batch_nodes`` seeds at ``fanouts`` each of vanilla and Sylvie-S
    (``SylvieConfig(mode="sync", bits=1)``, Uniform(1)'s decision,
    stochastic), the same batches and initial weights, Adam
    ``SAMPLED_LR``. Gates: each subgraph within ``SamplerShapes``' bounds,
    every step's launches ``TRAIN_LAUNCHES[("graphsage", run, "sync")]``,
    one recorded Sylvie-S step's SpMM and Low-bit Module calls bit-equal to
    the plain versions (:func:`recorded_kernels`), the first vanilla loss
    against the CPU's plain versions within ``SAMPLED_PARITY_RTOL``, every
    loss finite, vanilla's mean of the last five losses below
    ``SAMPLED_DESCENT`` x the first. Reports each batch's host ms
    (sample, partition, block: the ``Prefetcher``'s worker), the main
    thread's wait on the queue, the step's host and device ms, one
    profiled step's busy share, peak GB, the sampled sizes and the step's
    useful FLOPs (``_gnn_model_flops`` at the batch's own nodes and
    aggregated edges) over its device time. ``device="cpu"`` (with a small
    ``graph``) dry-runs it on the plain versions: no launches, events or
    profile."""
    import resource

    from repro_torch import configs
    from repro_torch.core import exchange as X
    from repro_torch.core.sylvie import SylvieConfig
    from repro_torch.graph import synthetic
    from repro_torch.graph.sampling import NeighborSampler, SamplerShapes
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.launch.cells import _gnn_model_flops
    from repro_torch.models.gnn import blocks as B
    from repro_torch.train import optimizer as optlib

    cuda = torch.device(device).type == "cuda"
    graph = dict(SAMPLED_GRAPH if graph is None else graph)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    g = synthetic.powerlaw_community(seed=SEED, **graph)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler = NeighborSampler(g, fanouts, seed=SEED)
    csr_s = time.perf_counter() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"[sampled] powerlaw_community({graph}, seed {SEED}): "
        f"{g.n_nodes} nodes, {g.n_edges} edges, generated in {gen_s:.1f} s "
        f"(host), its CSR in {csr_s:.1f} s; peak RSS {rss_gb:.2f} GB")
    shapes = SamplerShapes(batch_nodes, tuple(fanouts))
    torch.manual_seed(SEED)
    model = configs.get("graphsage").config().make(g.x.shape[1],
                                                   g.n_classes)
    names = tuple(all_kernels)

    def counts():
        return tuple(all_kernels[k]["k"].launches for k in names)

    runs = {"vanilla": SylvieConfig(mode="vanilla"),
            "sylvie_s": SylvieConfig(mode="sync", bits=1)}
    out = dict(launches={}, graph=dict(graph, nodes=g.n_nodes,
                                       edges=g.n_edges, gen_s=gen_s,
                                       csr_s=csr_s, peak_rss_gb=rss_gb))
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for run, cfg in runs.items():
        prof, rec = {}, dict(aggregate=[], scatter=[], quantize=[])

        def hook(b, step, run=run, prof=prof, rec=rec):
            if cuda and b == SAMPLED_PROFILED:
                got, wall, busy, groups, _ = profile_device(
                    step, f"one sampled GraphSAGE {run} step (batch {b})")
                prof.update(host_ms=wall, busy_ms=busy, by_group=groups)
                return got
            if cuda and run == "sylvie_s" and b == 1:
                with recording(B, "spmm", rec["aggregate"]), \
                        recording(X, "spmm", rec["scatter"]), \
                        recording(qops, "quantize_pack_rows",
                                  rec["quantize"]):
                    return step()
            return step()

        for meta in all_kernels.values():
            meta["k"].launches = 0
        res = sampled_train(fresh_sampler(sampler), model, cfg,
                            optlib.adam(SAMPLED_LR), n_batches,
                            batch_nodes=batch_nodes, device=device,
                            launches=counts, hook=hook)
        totals = counts()
        tag = f"[sampled] graphsage {run}"
        # on the CPU the wrappers run the plain versions: nothing launches
        step = dict(zip(TRAIN_KERNELS, TRAIN_LAUNCHES[
            ("graphsage", run, "sync")])) if cuda else {}
        want = tuple(step.get(k, 0) for k in names)
        for b, (info, got) in enumerate(zip(res["info"], res["launches"])):
            check(info["nodes"] <= shapes.max_nodes
                  and info["edges"] <= shapes.max_edges,
                  f"{tag} batch {b}: {info['nodes']} nodes, {info['edges']} "
                  f"edges, beyond SamplerShapes' {shapes.max_nodes} / "
                  f"{shapes.max_edges}")
            check(got == want, f"{tag} batch {b}: launches "
                  f"{dict(zip(names, got))}, expected "
                  f"{dict(zip(names, want))}")
        check(totals == tuple(n * n_batches for n in want),
              f"{tag}: the path's launches "
              f"{dict(zip(names, totals))}, {n_batches} x a step's")
        losses = res["losses"]
        check(all(np.isfinite(losses)), f"{tag}: losses {losses} finite")
        if run == "vanilla":
            last = float(np.mean(losses[-5:]))
            check(last < SAMPLED_DESCENT * losses[0],
                  f"{tag}: mean of the last five losses {last} not below "
                  f"{SAMPLED_DESCENT} x the first {losses[0]}")
        if rec["quantize"]:
            out["kernels"] = recorded_kernels(rec, tag)
            del rec
        info = res["info"]
        flops = [_gnn_model_flops("graphsage", model, i["nodes"],
                                  i["block_edges"], g.x.shape[1], True)
                 for i in info]

        def mean(xs):
            return float(np.mean(xs)) if len(xs) else None

        def mid(xs):
            return float(np.median(xs)) if len(xs) else None
        dev_ms = res["device_ms"]
        r = out[run] = dict(
            losses=losses, n_batches=n_batches,
            nodes=[i["nodes"] for i in info],
            edges=[i["edges"] for i in info],
            halo_rows=[i["halo_rows"] for i in info],
            real_halo_rows=[i["real_halo_rows"] for i in info],
            host_ms=dict(sample=mean([i["sample_ms"] for i in info]),
                         partition=mean([i["partition_ms"] for i in info]),
                         block=mean([i["block_ms"] for i in info])),
            wait_ms=dict(first=res["wait_ms"][0],
                         median_after_first=mid(res["wait_ms"][1:]),
                         mean_after_first=mean(res["wait_ms"][1:])),
            step_host_ms=mid(res["step_ms"][1:]),
            step_device_ms=mid(dev_ms[1:]),
            profiled=prof,
            busy_share=(prof["busy_ms"] / prof["host_ms"]) if prof else None,
            gflop_per_step=mean(flops) / 1e9,
            tflop_per_s=(float(np.median([f / d / 1e9 for f, d in
                                          zip(flops[1:], dev_ms[1:])]))
                         if dev_ms else None))
        out["launches"][f"graphsage_sampled_{run}_sync_step"] = dict(
            zip(names, res["launches"][-1]))
        log(f"{tag}: {json.dumps(r)}")
        out[f"{run}_params"] = res["params"]
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # the first vanilla batch again on the CPU's plain versions, from
        # the same weights and the same sampled batch
        t0 = time.perf_counter()
        cpu = sampled_train(fresh_sampler(sampler), model, runs["vanilla"],
                            optlib.adam(SAMPLED_LR), 1,
                            batch_nodes=batch_nodes, device="cpu")
        a, b = out["vanilla"]["losses"][0], cpu["losses"][0]
        check(abs(a - b) <= SAMPLED_PARITY_RTOL * abs(b),
              f"[sampled] the first vanilla loss: card {a}, CPU {b} (rtol "
              f"{SAMPLED_PARITY_RTOL})")
        out["parity"] = dict(card=a, cpu=b, rel=abs(a - b) / abs(b),
                             cpu_s=time.perf_counter() - t0)
        log(f"[sampled] the first vanilla batch on the CPU's plain versions"
            f": {json.dumps(out['parity'])}; kernels of one Sylvie-S step "
            f"bit-equal: {json.dumps(out['kernels'])}; peak "
            f"{out['peak_gb']:.2f} GB")
    del g, sampler
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[sampled] phase done in {out['seconds']:.1f} s")
    return out


def cells_phase(device: str = "cuda") -> dict:
    """[cells]: every (arch, shape) cell of ``launch.cells.all_cells()``
    built with ``build_cell(..., n_devices=4)``, one line each (arch, shape,
    step, model FLOPs, meta). Building them must allocate no device memory
    (``torch.cuda.memory_allocated`` unchanged)."""
    from repro_torch.launch.cells import all_cells, build_cell

    cuda = torch.device(device).type == "cuda"
    before = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    built = []
    for arch, shape in all_cells():
        cell = build_cell(arch, shape, n_devices=4)
        built.append(cell)
        log(f"[cells] {json.dumps(dict(arch=arch, shape=shape, step=cell.step, model_flops=cell.model_flops, meta=cell.meta))}")
    secs = time.perf_counter() - t0
    after = torch.cuda.memory_allocated() if cuda else 0
    check(len(built) == 40, f"[cells] {len(built)} cells, expected 40")
    check(after == before, f"[cells] building the cells allocated "
          f"{after - before} bytes on the card")
    log(f"[cells] {len(built)} cells built in {secs:.3f} s (host), "
        f"device memory unchanged ({before} bytes allocated)")
    return dict(n=len(built), seconds=secs)


def kernel_groups() -> tuple:
    """Every kernel of the port by name, in four groups (the serving path's,
    GAT's, the LM's, the zoo's): its ``Kernel`` (``k``, which counts
    launches), its source and the JAX function it replaces (file:line)."""
    from repro_torch.kernels.flash import ops as fops
    from repro_torch.kernels.gat import ops as gops
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.seg import ops as segops
    from repro_torch.kernels.spmm import ops as sops

    kernels = {
        qops.QUANTIZE_PACK.name: dict(
            k=qops.QUANTIZE_PACK, source="src/repro_torch/kernels/csrc/quant.cu",
            replaces="src/repro/kernels/quant/quant.py:38"),
        qops.UNPACK_DEQUANTIZE.name: dict(
            k=qops.UNPACK_DEQUANTIZE,
            source="src/repro_torch/kernels/csrc/quant.cu",
            replaces="src/repro/kernels/quant/quant.py:65"),
        sops.SPMM.name: dict(
            k=sops.SPMM, source="src/repro_torch/kernels/csrc/spmm.cu",
            replaces="src/repro/kernels/spmm/spmm.py:37"),
    }
    # GAT's kernels are the port's own: the JAX package computes the same
    # functions outside any Pallas kernel, at these lines
    gat_kernels = {
        sops.SPMM_HEADS.name: dict(
            k=sops.SPMM_HEADS, source="src/repro_torch/kernels/csrc/spmm.cu",
            replaces="src/repro/models/gnn/models.py:141"),
        gops.GAT_SOFTMAX.name: dict(
            k=gops.GAT_SOFTMAX, source="src/repro_torch/kernels/csrc/gat.cu",
            replaces="src/repro/models/gnn/blocks.py:132"),
        gops.SDDMM_HEADS.name: dict(
            k=gops.SDDMM_HEADS, source="src/repro_torch/kernels/csrc/gat.cu",
            replaces="src/repro/models/gnn/models.py:140"),
        gops.GAT_SOFTMAX_BWD.name: dict(
            k=gops.GAT_SOFTMAX_BWD,
            source="src/repro_torch/kernels/csrc/gat.cu",
            replaces="src/repro/models/gnn/blocks.py:132"),
    }
    # the flash backward replaces no Pallas kernel: the JAX package
    # differentiates blockwise_attention itself, at this line
    lm_kernels = {
        fops.FLASH_FWD.name: dict(
            k=fops.FLASH_FWD, source="src/repro_torch/kernels/csrc/flash.cu",
            replaces="src/repro/kernels/flash/flash.py:32"),
        fops.FLASH_BWD_DQ.name: dict(
            k=fops.FLASH_BWD_DQ,
            source="src/repro_torch/kernels/csrc/flash_bwd.cu",
            replaces="src/repro/models/lm/model.py:126"),
        fops.FLASH_BWD_DKDV.name: dict(
            k=fops.FLASH_BWD_DKDV,
            source="src/repro_torch/kernels/csrc/flash_bwd.cu",
            replaces="src/repro/models/lm/model.py:126"),
    }
    # the zoo's kernels, the port's own: jax.ops.segment_max in the JAX
    # package's agg_max (agg_min is -agg_max(-msgs)), and its VJP (JAX
    # autodiff)
    zoo_kernels = {
        k.name: dict(k=k, source="src/repro_torch/kernels/csrc/seg.cu",
                     replaces="src/repro/models/gnn/blocks.py:104")
        for k in (segops.SEG_MAX_MIN, segops.SEG_MAX_MIN_BWD)}
    return kernels, gat_kernels, lm_kernels, zoo_kernels


def kernel_table() -> dict:
    """``kernel_groups`` in one table. Every phase, and each tool that runs
    one alone, zeroes and reads these counts."""
    return {k: v for group in kernel_groups() for k, v in group.items()}


def main() -> int:
    # -- 1. card -------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[card] {card_line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import datasets
    from repro_torch.core.exchange import gather_boundary
    from repro_torch.dist.runtime import Runtime
    from repro_torch.kernels import build
    from repro_torch.kernels.quant import ops as qops
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.spmm import ref as sref
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.models.gnn import blocks as B
    from repro_torch.models.gnn.models import GCN
    from repro_torch.serve import InferenceEngine, ServeConfig

    kernels, gat_kernels, lm_kernels, zoo_kernels = kernel_groups()
    all_kernels = kernel_table()

    # -- 2. build ------------------------------------------------------------
    secs = build.build_all()
    log(f"[build] {len(build.SOURCES)} sources -> {build.BUILD_DIR} in "
        f"{secs:.1f} s")

    # -- 3. the slice: GCN 256x2 serving reddit_like@paper, P=4, 1 bit --------
    t0 = time.perf_counter()
    pg, _ = datasets.load_partitioned("reddit_like@paper", n_parts=4)
    d_in, n_cls = pg.x.shape[-1], pg.n_classes
    log(f"[slice] reddit_like@paper: {pg.part_of.size} nodes, d_feat {d_in}, "
        f"{n_cls} classes, n_local {pg.plan.n_local}, halo rows "
        f"{pg.plan.halo_rows}, buckets {pg.plan.bucket_sizes.tolist()}, "
        f"{int(pg.edge_mask.sum())} edges ({time.perf_counter() - t0:.1f} s)")
    model = GCN(d_in, 256, n_cls, n_layers=2,
                generator=torch.Generator().manual_seed(SEED))
    runtime = Runtime.simulated(4)
    eng = InferenceEngine(model, pg, config=ServeConfig(bits=1),
                          runtime=runtime, seed=SEED)
    log(f"[slice] engine ready: csr nnz {eng.block.csr.nnz}, max in-degree "
        f"{int(torch.diff(eng.block.csr.row_ptr).max())}")

    for meta in all_kernels.values():
        meta["k"].launches = 0
    rep = eng.full_sweep()
    torch.cuda.synchronize()
    serve_launches = {name: meta["k"].launches
                      for name, meta in all_kernels.items()}
    launches = {name: serve_launches[name] for name in kernels}
    check(all(serve_launches[k] == 0 for k in (*lm_kernels, *gat_kernels,
                                               *zoo_kernels)),
          "the GCN path launches no flash, no GAT and no zoo kernel")
    log(f"[slice] full sweep {rep.seconds * 1e3:.3f} ms (first, host clock), "
        f"launches {launches}, wire bytes {rep.wire_bytes}")
    for name, n in launches.items():
        exact = name != sops.SPMM.name
        check(n == eng.n_sites if exact else n >= eng.n_sites,
              f"{name} launched {n} times in one sweep, expected "
              f"{'' if exact else 'at least '}{eng.n_sites}")
    logits = eng.logits
    check(logits.shape == (pg.part_of.size, n_cls), "logits shape")
    check(bool(np.isfinite(logits).all()), "logits finite")

    rng = np.random.default_rng(SEED)
    for b in range(3):
        ids = np.concatenate([rng.choice(pg.global_ids[p][pg.node_mask[p]],
                                         size=64, replace=False)
                              for p in range(4)])
        out = eng.query(ids)
        check(out.logits.shape == (256, n_cls)
              and np.array_equal(out.logits, logits[ids]),
              f"query batch {b} == cached logits")
    log("[slice] 3 query batches of 256 ids over 4 partitions answered")

    changed = np.concatenate([rng.choice(pg.global_ids[p][pg.node_mask[p]],
                                         size=16, replace=False)
                              for p in range(4)])
    rows = rng.normal(0, 1, (changed.size, d_in)).astype(np.float32)
    drep = eng.refresh(changed, rows)
    check(drep.kind == "delta", f"refresh ran as {drep.kind}")
    d_logits = eng._logits_host.copy()
    d_layers, d_halos = eng._layers, eng._halos
    frep = eng.full_sweep()
    check(np.array_equal(d_logits, eng._logits_host),
          "delta refresh logits == full sweep logits, bit for bit")
    for a, b in zip(d_layers + d_halos, eng._layers + eng._halos):
        check(torch.equal(a, b), "delta refresh caches == full sweep caches")
    log(f"[slice] delta refresh of {changed.size} nodes: {drep.seconds * 1e3:.3f}"
        f" ms, rows/site {drep.affected_rows} vs {frep.affected_rows}, wire "
        f"bytes {drep.wire_bytes} vs {frep.wire_bytes}; equals the full sweep "
        f"bit for bit")

    sweep_ms = sorted(eng.full_sweep().seconds * 1e3 for _ in range(5))
    log(f"[slice] full sweep (host clock, 5 runs): median {sweep_ms[2]:.3f} ms,"
        f" min {sweep_ms[0]:.3f} ms")

    # where one full sweep's device time goes (CUDA kernels by name)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = eng.full_sweep().seconds * 1e3
    on_dev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_dev) / 1e3
    log(f"[profile] one full sweep: host {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}% of the host time), "
        f"{sum(e.count for e in on_dev)} device launches")
    for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x  {e.key[:100]}")

    eng_s = InferenceEngine(model, pg, config=ServeConfig(bits=1,
                                                          stochastic=True),
                            runtime=runtime, seed=SEED)
    srep = eng_s.full_sweep()
    check(bool(np.isfinite(eng_s.logits).all()), "stochastic logits finite")
    log(f"[slice] stochastic 1-bit sweep {srep.seconds * 1e3:.3f} ms (first)")

    # -- 4. small input: card vs the CPU's plain versions ----------------------
    spg, _ = datasets.load_partitioned("yelp_like@smoke", n_parts=4)
    small = GCN(spg.x.shape[-1], 16, spg.n_classes, n_layers=2,
                generator=torch.Generator().manual_seed(SEED))
    params = params_to_numpy(small)
    for bits in (32, 1):
        out = {}
        for dev in ("cuda", "cpu"):
            e = InferenceEngine(GCN(spg.x.shape[-1], 16, spg.n_classes), spg,
                                params, config=ServeConfig(bits=bits),
                                runtime=Runtime.simulated(4, device=dev))
            e.full_sweep()
            out[dev] = e
        if bits == 32:
            err = float(np.abs(out["cuda"].logits - out["cpu"].logits).max())
            check(np.allclose(out["cuda"].logits, out["cpu"].logits,
                              rtol=1e-4, atol=1e-5),
                  f"32-bit logits card vs CPU (max abs err {err})")
        else:
            check(torch.equal(out["cuda"]._halos[0].cpu(), out["cpu"]._halos[0]),
                  "1-bit site-0 halo card == CPU")
    log(f"[small] yelp_like@smoke: 32-bit logits card vs CPU max abs err "
        f"{err:.3g} (rtol 1e-4, atol 1e-5); 1-bit site-0 halos equal")

    # -- 5. kernels vs plain versions on the slice's own tensors ---------------
    plan, csr = eng.block.plan, eng.block.csr
    # the same CSR under other plans, timed only: other segment lengths, and
    # the units sorted heaviest first instead of in CSR order
    alt_plans = {}
    for seg in (64, 256):
        alt_plans[f"segment {seg}"] = sref.CSR(
            csr.row_ptr, csr.col, csr.w, csr.n_cols,
            *(x.to(csr.col.device) if torch.is_tensor(x) else x
              for x in sref.split_plan(csr.row_ptr.cpu().numpy(), seg)))
    length = csr.units[:, 1] - csr.units[:, 0]
    alt_plans["heaviest first"] = dataclasses.replace(csr, units=csr.units[
        torch.argsort(length, descending=True, stable=True)].contiguous())
    errs = {name: 0.0 for name in kernels}
    detail = []
    for site, h in enumerate(eng._layers):
        buf = gather_boundary(h, plan).reshape(-1, h.shape[-1]).contiguous()
        rows_, d = buf.shape
        for bits in (1, 2, 4, 8):
            for stochastic in (False, True):
                u = torch.rand(buf.shape, device=buf.device,
                               generator=torch.Generator("cuda").manual_seed(
                                   site * 100 + bits)) if stochastic else None
                q_err, d_err = check_quant(qops, qref, buf, u, bits,
                                           f"site {site}")
                errs["quantize_pack"] = max(errs["quantize_pack"], q_err)
                errs["unpack_dequantize"] = max(errs["unpack_dequantize"],
                                                d_err)
        # the sweep's own call: 1 bit, deterministic, bf16 scale/zero
        w, ec = qref.packed_width(d, 1), 2 * 2
        u = torch.rand(buf.shape, device=buf.device,
                       generator=torch.Generator("cuda").manual_seed(site))
        pk, sk, zk = qops.quantize_pack_rows(buf, None, 1, torch.bfloat16)
        quant = lambda: qops.quantize_pack_rows(buf, None, 1, torch.bfloat16)
        squant = lambda: qops.quantize_pack_rows(buf, u, 1, torch.bfloat16)
        deq = lambda: qops.dequantize_rows(pk, sk, zk, 1, d)
        qb, qo = bound(rows_ * d * 4 + rows_ * (w + ec), rows_ * d * 8)
        qsb, qso = bound(2 * rows_ * d * 4 + rows_ * (w + ec), rows_ * d * 10)
        db, do = bound(rows_ * (w + ec) + rows_ * d * 4, rows_ * d * 2)
        detail.append(dict(
            site=site, shape=[rows_, d], bits=1, scale_dtype="bfloat16",
            quantize_ms=device_ms(quant, "quantize_pack"),
            quantize_event_ms=cuda_ms(quant),
            quantize_plain_ms=cuda_ms(lambda: [
                t.bfloat16() for t in qref.quantize_pack_ref(buf, None, 1)]),
            quantize_bound_ms=qb, quantize_bound_by=qo,
            quantize_stochastic_ms=device_ms(squant, "quantize_pack"),
            quantize_stochastic_event_ms=cuda_ms(squant),
            quantize_stochastic_bound_ms=qsb,
            quantize_stochastic_bound_by=qso,
            dequantize_ms=device_ms(deq, "unpack_dequantize_kernel"),
            dequantize_event_ms=cuda_ms(deq),
            dequantize_plain_ms=cuda_ms(lambda: qref.unpack_dequantize_ref(
                pk, sk.float(), zk.float(), 1, d)),
            dequantize_bound_ms=db, dequantize_bound_by=do))
        table = B.halo_table(h, eng._halos[site])
        table = table.reshape(-1, table.shape[-1]).contiguous()
        out_k = sops.spmm(table, csr)
        out_r = sref.spmm_ref(table, csr)
        err = float((out_k - out_r).abs().max())
        check(torch.equal(out_k, out_r), f"spmm site {site}: bit-equal to the "
              f"plain version (max abs err {err})")
        check(torch.equal(out_k, sops.spmm(table, csr)),
              f"spmm site {site}: same bits on a second run")
        log(f"[kernels] spmm site {site}: bit-equal to the plain version and "
            f"on a second run; {csr.long_rows.numel()} of {csr.n_rows} rows "
            f"split at SEGMENT {sref.SEGMENT} into {csr.n_partials} segments, "
            f"{csr.units.shape[0]} work units")
        errs["spmm_csr"] = max(errs["spmm_csr"], err)
        with warnings.catch_warnings():   # sparse CSR is "beta" in PyTorch
            warnings.simplefilter("ignore")
            sparse = torch.sparse_csr_tensor(csr.row_ptr, csr.col, csr.w,
                                             size=(csr.n_rows, csr.n_cols))
        dd = table.shape[-1]
        sb, so = bound(table.numel() * 4 + (csr.n_rows + 1) * 4 + csr.nnz * 8
                       + csr.n_rows * dd * 4, 2 * csr.nnz * dd)
        detail[-1].update(
            spmm_shape=[csr.n_rows, csr.n_cols, dd, csr.nnz],
            spmm_ms=cuda_ms(lambda: sops.spmm(table, csr)),
            spmm_plain_ms=cuda_ms(lambda: sref.spmm_ref(table, csr),
                                  iters=2, warmup=1),
            spmm_library_ms=cuda_ms(lambda: torch.sparse.mm(sparse, table)),
            spmm_bound_ms=sb, spmm_bound_by=so,
            spmm_other_plans_ms={
                name: cuda_ms(lambda: sops.spmm(table, alt))
                for name, alt in alt_plans.items()})
        log(f"[kernels] site {site}: {json.dumps(detail[-1])}")
    log(f"[kernels] max abs err vs plain versions: {errs}")
    n_cases = quant_shape_sweep(qops, qref)
    log(f"[kernels] quantize/dequantize shape sweep: {n_cases} cases (bits "
        f"1/2/4/8, stochastic and deterministic, d {list(SWEEP_D)}, rows "
        f"1/7/1000, contiguous / offset by one element / constant rows), "
        f"scale/zero float32 and bfloat16: all bit-equal to the plain "
        f"versions")
    del eng, eng_s, pg, model, runtime, plan, csr, table, out_k, out_r, buf
    del pk, sk, zk, u
    del alt_plans
    del sparse, prof, out, e, spg, small
    torch.cuda.empty_cache()

    # -- 6. GCN, GraphSAGE, GAT training on reddit_like@paper ------------------
    tr = train_phase(all_kernels)

    # -- 7. the backward's kernels vs their plain versions ---------------------
    trk = train_kernels_phase(tr.pop("recorded"), tr.pop("block"))
    for name in errs:
        errs[name] = max(errs[name], trk[name])
    torch.cuda.empty_cache()

    # -- 7b. GAT's kernels vs their plain versions ------------------------------
    gk = gat_kernels_phase(tr.pop("gat_recorded"), tr.pop("gat_block"))
    torch.cuda.empty_cache()

    # -- 8. training, card vs the CPU's plain versions -------------------------
    train_parity_phase()

    # -- 8b. analysis: the census contracts (the sharded ones in [sharded]) ---
    an = analysis_phase(tr.pop("pg"))
    torch.cuda.empty_cache()

    # -- 9. the LM: granite-3-2b at full width, prefill + greedy decode -------
    lm = lm_phase(all_kernels)

    # -- 10. small LMs: card vs the CPU's plain versions -----------------------
    lm_small_phase()

    # -- 10b. olmoe-1b-7b, deepseek-v2-236b, gemma2-27b: MoE, MLA, softcap ----
    moe = lm_moe_phase(all_kernels)
    torch.cuda.empty_cache()

    # -- 11. the flash kernel vs its plain versions on layer 0's q/k/v ---------
    fl = flash_phase(*lm.pop("qkv"))
    torch.cuda.empty_cache()

    # -- 11'. the flash backward kernels vs their plain version ---------------
    fb = flash_bwd_phase()

    # -- 11''. LM training: granite-3-2b (40 layers), olmoe, gemma2, deepseek --
    lmt = lm_train_phase(all_kernels)

    # -- 11a. the zoo: PNA, MeshGraphNet, SchNet, NequIP at full width --------
    zoo = zoo_phase(all_kernels)
    for name in errs:
        errs[name] = max(errs[name], zoo["wide"]["kernels"][name])
    torch.cuda.empty_cache()

    # -- 11a'. DLRM at the MLPerf widths, tables capped at 2^22 rows ----------
    dl = dlrm_phase(all_kernels)
    torch.cuda.empty_cache()

    # -- 11a''. sampled training: the minibatch_lg cell, GraphSAGE 256x2 -----
    sp = sampled_phase(all_kernels)
    torch.cuda.empty_cache()

    # -- 11a'''. the cell inventory: 40 cells, nothing allocated -------------
    cells_phase()

    # -- 11b. the serving front: serve_once, store, degraded mode, tracing -----
    # last: its host work (checkpoints written and restored, the store's
    # host tables) must not shift the host-clock times of the phases above
    sf = serve_front_phase(all_kernels)

    # -- 11c. chaos: faults, the overlap schedule, kill-and-resume, scenarios --
    # last: it spawns processes and writes checkpoints
    torch.cuda.empty_cache()
    ch = chaos_phase(all_kernels)

    # -- 11d. sharded: the multi-process runtime, four ranks on this card ----
    torch.cuda.empty_cache()
    sh = sharded_phase(card_line)
    for name in errs:
        errs[name] = max(errs[name], sh["zoo"]["kernels"][name])

    # -- 11e. sharded-serve: serving under it, the front on rank 0 -------------
    ss = sharded_serve_phase(card_line)

    # -- 11f. DLRM under the sharded runtime, its 1-bit embedding exchange ----
    torch.cuda.empty_cache()
    dls = dlrm_sharded_phase(card_line)

    sa = sh["analysis"]
    log(f"[analysis] {an['contracts'] + sa['contracts']} contracts run "
        f"({an['contracts'] - 1} simulated on the card, the full-width GCN "
        f"256x2 Sylvie-S census on reddit_like@paper, {sa['contracts']} "
        f"sharded in [sharded]'s spawn of {SHARDED_PARTS} gloo ranks on "
        f"cuda:0): 0 findings; "
        f"{an['simulated_s'] + an['wide_s'] + sa['seconds']:.1f} s "
        f"({an['simulated_s']:.1f} simulated, {an['wide_s']:.1f} full-width, "
        f"{sa['seconds']:.1f} sharded); {card_line}")

    # -- 12. summary ----------------------------------------------------------
    s0 = detail[0]
    times = {
        "quantize_pack": ("quantize", None),
        "unpack_dequantize": ("dequantize", None),
        "spmm_csr": ("spmm", "spmm_library_ms"),
    }
    # the Low-bit Module's further times: event time, stochastic rounding
    extra = {
        "quantize_pack": ("event_ms", "stochastic_ms", "stochastic_event_ms",
                          "stochastic_bound_ms"),
        "unpack_dequantize": ("event_ms",),
        "spmm_csr": (),
    }
    # launches per path: one serving sweep (the slice's, and the serving
    # front's of each arch), one training step of each kind, one LM generate
    per_path = {name: dict(
        gcn_serve_sweep=serve_launches[name],
        **{path: n.get(name, 0) for path, n in sf["launches"].items()},
        **{path: n[name] for path, n in tr["launches"].items()},
        **{path: n[name] for path, n in ch["launches"].items()},
        **{path: n.get(name, 0) for path, n in sh["launches"].items()},
        **{path: n.get(name, 0) for path, n in ss["launches"].items()},
        **{path: n[name] for path, n in zoo["launches"].items()},
        **{path: n[name] for path, n in dl["launches"].items()},
        **{path: n[name] for path, n in dls["launches"].items()},
        **{path: n[name] for path, n in sp["launches"].items()},
        lm_generate=lm["launches"][name],
        **{f"{arch}_generate": run["launches"][name]
           for arch, run in moe.items()},
        **{f"{arch}_train_step": run["launches"][name]
           for arch, run in lmt.items()}) for name in all_kernels}
    summary = []
    for name, meta in kernels.items():
        key, lib = times[name]
        summary.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=s0[f"{key}_ms"],
            plain_ms=s0[f"{key}_plain_ms"], bound_ms=s0[f"{key}_bound_ms"],
            bound_by=s0[f"{key}_bound_by"],
            library_ms=s0[lib] if lib else None,
            shape=s0["spmm_shape" if key == "spmm" else "shape"],
            launches_per_path=per_path[name],
            **{k: s0[f"{key}_{k}"] for k in extra[name]},
            **({k: v for k, v in trk.items() if k.startswith(
                ("transposed", "scatter"))} if key == "spmm" else {}),
            **({f"dlrm_table_grad_{k}": v for k, v in dl["spmm"].items()}
               if key == "spmm" else {})))
    # GAT's kernels: their launches in one GAT Sylvie-S step (their main
    # path), times on that step's tensors; the backward's variants beside
    gat_step = tr["launches"]["gat_train_sylvie_s_sync_step"]
    for name, meta in gat_kernels.items():
        main = gk[name]
        twin = gk.get(f"{name}_t")
        summary.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=gat_step[name],
            max_abs_err=max(main["max_abs_err"],
                            twin["max_abs_err"] if twin else 0.0),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"],
            bit_equal=main["bit_equal"], launches_per_path=per_path[name],
            **({k: main[k] for k in ("device_ms", "phases_ms",
                                     "cuda_launches_per_call") if k in main}),
            **({f"transposed_{k}": twin[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "bit_equal", "device_ms", "phases_ms",
                "cuda_launches_per_call")
                if twin.get(k) is not None}
               if twin else {}),
            **({k: main[k] for k in ("gathered_gb", "gather_tb_s")
                if k in main}),
            **({"transposed_gather_path_ms": twin["gather_path_ms"],
                "transposed_gather_tb_s": twin["gather_tb_s"]}
               if twin and "gather_path_ms" in twin else {}),
            **({"other_shapes_ms": main["shapes"]} if "shapes" in main
               else {}),
            **({"transposed_other_shapes_ms": twin["shapes"]}
               if twin and "shapes" in twin else {})))
    meta = lm_kernels["flash_fwd"]
    summary.append(dict(
        name="flash_fwd", route="cuda", source=meta["source"],
        replaces=meta["replaces"], launches=lm["launches"]["flash_fwd"],
        launches_per_path=per_path["flash_fwd"],
        max_abs_err=fl["max_abs_err"], ms=fl["ms"], plain_ms=fl["plain_ms"],
        bound_ms=fl["bound_ms"], bound_by=fl["bound_by"],
        library_ms=fl["library_ms"], shape=fl["shape"],
        model_call_ms=fl["bshd_ms"], model_call_bound_ms=fl["bshd_bound_ms"],
        d128_ms=fl["d128_ms"], d128_library_ms=fl["d128_library_ms"],
        lm_shapes=fl["lm_shapes"]))
    # the flash backward: launches in one granite-3-2b training step (the
    # main path), times at its layer call; the plain version and the
    # library compute the whole backward (dq, dk and dv), beside each kernel
    main = fb["granite"]
    for name, key in (("flash_bwd_dq", "dq"), ("flash_bwd_dkdv", "dkdv")):
        meta = lm_kernels[name]
        summary.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=lmt["granite-3-2b"]["launches"][name],
            launches_per_path=per_path[name],
            max_abs_err=max(c[f"{w}_max_abs_err"] for c in fb.values()
                            for w in (("dq",) if key == "dq"
                                      else ("dk", "dv"))),
            ms=main[f"{key}_ms"], plain_ms=main["plain_ms"],
            bound_ms=main[f"{key}_bound_ms"],
            bound_by=main[f"{key}_bound_by"],
            library_ms=main["library_ms"], library=main["library"],
            plain_and_library_compute="dq, dk and dv",
            pair_ms=main["ms"], pair_bound_ms=main["bound_ms"],
            shape=main["shape"],
            shapes={tag: {x: c[x] for x in (
                f"{key}_ms", f"{key}_bound_ms", "ms", "plain_ms",
                "library_ms") if x in c} for tag, c in fb.items()}))
    # the zoo's kernels: launches in one PNA Sylvie-S step (the main path),
    # times at its first layer's calls
    sm = zoo["seg_max_min"]
    for name, pre in (("seg_max_min_csr", ""), ("seg_max_min_bwd_csr",
                                                "bwd_")):
        summary.append(dict(
            name=name, route="cuda", source=zoo_kernels[name]["source"],
            replaces=zoo_kernels[name]["replaces"],
            launches=zoo["launches"]["pna_train_sylvie_s_sync_step"][name],
            max_abs_err=max(sm[f"{pre}max_abs_err"],
                            sh["zoo"]["kernels"][name]),
            ms=sm[f"{pre}ms"],
            plain_ms=sm[f"{pre}plain_ms"], bound_ms=sm[f"{pre}bound_ms"],
            bound_by=sm[f"{pre}bound_by"],
            library_ms=None if pre else sm["library_ms"],
            **({} if pre else {"library": sm["library"]}),
            shape=sm["shape"], bit_equal=sm["bit_equal"],
            tied_outputs=sm["tied_outputs"],
            launches_per_path=per_path[name]))
    print(json.dumps({"kernels": summary}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
