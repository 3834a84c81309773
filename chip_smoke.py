#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (som_lvq_pak_torch).

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # the e2e cells under torch.profiler
    python3 chip_smoke.py --mesh       # the mesh phases 14-19 alone
    python3 chip_smoke.py --state      # what phase 3b leaves for phase 7

Needs one CUDA device and nvcc; exits non-zero without them.  With --mesh
it builds the kernels and runs phase 6's single-device run and the mesh
phases only; on a host with at least as many cards as a world has ranks
the world runs NCCL, one card per rank (parallel.mesh's backend rule), and
on a host with four cards it also runs e2e_mesh_multihost_2x2 (below).  With
--profile it builds the kernels and runs each e2e cell of phases 4-13 once
(after its warm-up; phase 5's eight steps, their codebook's upload
included) under torch.profiler, printing for its training and
its evaluation one "profile" line: the wall, the device's busy time (the
union of its kernel and copy intervals), the idle share, and the kernels
that took longest.  With --state it builds the kernels and times phase
7's cell five times each: fresh, after phase 3b's kernel phases, after
handing back their memory (gc, torch.cuda.empty_cache) and after 20 s idle,
with the allocator's reserved GiB and the card's clock, temperature and
power draw beside each reading (one "state" line).  Without arguments,
phases, each printing one JSON line:

1. env      torch/CUDA/nvcc versions, card name and power limit;
2. build    compiles som_lvq_pak_torch/csrc/*.cu for sm_90a (timed), then
            with the three slowest nvcc processes (each source's compile
            seconds, from the build's log); one "ptxas" line: registers and
            spill bytes of each instantiation of K1, K2 and their prologue,
            K8, K10, K4 and its prologue, K9, K3's, K13's, K14's and K17's
            Hopper walk and its prologue, K6 and its prologue, K5, K11, K12,
            K14's walk (its stagger and int8_win) and K15,
            from nvcc's -Xptxas -v report (K5's, K11's, K10's and K14's
            Hopper walk must spill nothing and keep their wgmma
            unserialized); one "sass" line: the HMMA
            (mma.sync tensor-core) instructions in each instantiation of the
            tensor-core kernels K3, K13, K14's main form and K17 past D 128,
            K7, K12, K14's walk and K16, the HGMMA
            (TF32 wgmma) instructions in each of K1's, K2's, K8's, K10's,
            K4's, K9's, K6's, K5's, K11's and K3's, K13's, K14's and K17's
            Hopper walk (up to D 128; none may have an HMMA),
            the IMMA (int8 mma.sync) instructions in each instantiation of
            K14's int8_win walk, the IGMMA (int8 wgmma) instructions in each
            of K15's, and the UTMALDG (TMA tile loads) in each of K1's,
            K2's, K8's, K10's, K4's, K9's, K6's, K5's, K11's, K3's, K13's,
            K14's and K17's walk and K15's, from cuobjdump
            --dump-sass of the library (none fails the run, as does an IDP4A
            anywhere in it);
            then g++ builds the native data-file engine (data/native_io.py
            over native/somvq_io.cpp) into the same folder, timed; the I/O
            phases (13e-13g) fail unless it is loaded and in use;
3. kernels  each CUDA kernel against its plain PyTorch version on the card
            (winners equal except at near-ties, values/codebooks to 1e-4),
            with kernel and plain times from CUDA events and the kernel's
            bound (the least time the card could take: FP32 FLOPs at
            67 TFLOP/s or bytes at 3.35 TB/s, whichever is larger); K1-K14
            (K14's options too) also with the bound of their route
            (the TF32 products they issue at 495 TFLOP/s: three per FP32
            product, two for K6's weight mass and K4's and K9's keep.(m o
            m), one for K14's under batch_bf16; int8_win's winners as int8
            operations at 1979 TOP/s) and the share of it they
            reach, and run twice on the same inputs, bit-equal.  K1 and
            K2's prologue (split_codes: the codebook split into TF32 hi and
            lo, ||m||^2) is bit-equal to its plain version at D 5, 37, 64,
            130 and 65536 x 64, and so is K4's (split_masked_codes: m and m
            o m split into TF32 hi and lo) at 65536 x 64, D 5, 37 and 130,
            its times in K4's record (prologue_ms, prologue_launch_ms).  K1 is
            also bit-equal to K2 on the same inputs at every K1 shape (one
            walk), and the
            min over K1 on two shards of a codebook (split off a tile
            boundary, merged by the sharded winner's rule) has the whole
            run's values bit for bit and its winners except at value ties.
            K5 and K6 record their codebook's and the plain version's mean
            and max distance from the blend taken in float64, and K5's
            codebook is K3's on the same winners bit for bit.  K1, K2, K4,
            K8, K9
            and K10 carry library_ms at their record's shape: torch.addmm
            (keep @ (m o m)^T as its input under a mask), then argmin,
            argmax or topk, in the plain versions' row chunks; K3, K5-K7
            and K11-K14 carry null: no one PyTorch call computes their
            function (the plain version's chain, neighborhood_w, FP32
            cuBLAS products, the blend, the winners, is plain_ms).  K2
            also runs at a 16384-row StreamingReader chunk.  K7
            (som_vmem_train_steps) runs at e2e_64x64_1M's group shape,
            bench.py:prep_vmem_steps's geometry,
            bench.py:prep_somexample_shape's, a ragged shape with every code
            three times and the largest codebook the grouped path takes
            (128x64 at D 128), then 32x32, 64x64 and 128x128 at D 5, 64,
            128 and 129 (K 8, B 256; not 128x128 at 129, which the
            mma.sync kernel cannot hold resident); at each the codebook
            and winners are bit-equal to K chained K3 launches and to a
            rerun, and with zero alphas the codebook stays bit-equal to its
            input; beside it the K3 chain's time (and K13's at the first
            shape); at the first, the fifth and the new shapes, up to D 128
            (its walk, csrc/som_vmem_steps_sm90.cu) at every cluster size
            the card holds resident, past it at 16, 32 and 64 rows per CTA,
            each bit-equal to the K3 chain, with one "k7_cluster" (or
            "k7_rows") line of the pick and each size's time.  K12 also at
            D 128 (its walk) and 129, and K11 then K12 bit-equal to K3 on a
            shard at D 128.
            K1 also runs at the LVQ steps' B 1024, a mesh rank's B 512 x
            32768, D 37, D 130, the online scan's B 1 x 4096 and at the LVQ
            accuracy's single launch over 1M x 65536; K4 at the masked LVQ
            cell's B 1024 x 4096, D 37, D 130 and B 1 x 4096 (the one row
            partly masked, and again fully masked: index 0, value 0).  The LVQ steps' segment sum
            (not a TPU kernel) at the olvq1 step's B 1024 x D 64 (and 66
            columns) into 65,536 codes, into 4096, one column, a hot segment
            and B 8192 (past its one-CTA sort), bit-equal to np.add.at and
            to a rerun, timed against index_add_.  The fused-step kernels: K3
            (factored=False) at the 1M cell's step, the 128x128 step, 12x8
            at D 64 and D 5, a ragged 10x6 map at D 37, 16x16 at D 200,
            K13's shapes (64x64 B 512, 256x256 B 1024, 64x64 bubble B 4096)
            and with a bf16 codebook; K13 (som_fused_factored_step) at the
            128x128 cell's step, 256x256 at B 1024, 64x64 bubble at B 4096, a
            rect map, the 64x64 B 512 step, every code three times (exact
            ties), K3's D 5, D 37 and D 200 cases, 64x64 gaussian B 4096 and
            a bf16 codebook, codes within 1e-5 and values within 1e-4, each
            run twice (bit-equal), with one "k13_vs_k3" line per shape K3
            also ran at; K14's main form (som_fused_factored_chunked_step) at
            the 64x64 B 4096 step with both bf16 options, bench.py's headline
            256x256 shapes (B 4096 with the bf16 x-pattern, B 8192 with both
            options), bubble with and without bf16 batches and a bf16
            codebook (values within 5e-3 of the plain run under bf16
            batches), each run twice (bit-equal), at the cluster
            ops.som_step.k14_cluster picks; its 64x64 cases, the trainer's
            other K14 maps (32x32 and 64x32 gaussian at B 4096) and 128x128
            at B 4096 also at each cluster size 1, 2, 4 and 8, each held to
            the same gates, with one "k14_cluster" line each (ms at every
            size, the pick, its route share) and for the 64x64 cases one
            "k14_vs_k13" line (K13 at the same shape); on a float32
            codebook each
            fused-step kernel's winners and values are also held against the
            plain scoring of its own updated rows; K14's bound under bf16
            batches is its FLOPs at the BF16 tensor peak (989 TFLOP/s), its
            route's bound one TF32 product per FP32 product there; the
            exact bubble boundary through K13 and K14; K5 and K6 at the
            masked 1M cell's step, 128x128, 12x8 at D 64 and D 5, a ragged
            10x6 map at D 37 and 16x16 at D 200, and the exact bubble
            boundary through K6;
3b. kernels  K14's stagger at every K14 case and a bf16 codebook,
            bit-equal (codebook, winners, values) to K14's main form on the
            same inputs, and at 64x64 also on persistent grids forced to 1
            and 3 CTAs (several tiles per CTA);
            K14's int8_win at int8_step_ab's step (256x256 B 4096, chunk
            1024, bf16 x-pattern), 64x64 with both bf16 options, 64x64
            bubble, bf16 batches at 256x256 B 8192 and a bf16 codebook: the
            codebook bit-equal to K14's main form's without it, stagger
            bit-equal, winners
            equal to the plain int8 scoring of its own rows (values within
            1e-5 relative), against the plain int8 run equal except within one
            quantization step, values within 5e-5 where they agree; a bf16
            codebook's winners and values bit-equal to the same step on the
            codebook widened to float32 (its bound: the update at the FP32 or
            BF16 peak plus the winners at the INT8 peak, 1979 TOP/s; its
            route's: the update's TF32 products plus the int8 winners).  K15 and K16
            (int8/f32_winner_probe) at tools/int8_probe.py's 65536 x 64 x
            4096, at 999 x 5 x 1000, with every row twice and at 1000 x 130
            x 999, bit-equal to plain and to a rerun, with library_ms (torch._int_mm / torch.mm,
            then amax); K15 (int8 wgmma fed by a TMA ring) also at 1000 x 64
            x 999 with every maximum negative (codes past N must not win),
            with rows and columns of -128, at 200 x 64 x 100 (N below one
            256-code tile, B not a multiple of 64), 1 x 1 x 1, D 256, D 37
            (m copied padded) and the record shape with its codebook
            splits forced to 1 and to 256, each bit-equal to plain and to a
            rerun, its record with its route (wgmma) and bound_pct; K16
            also on normal floats at 65536 x 64 x 4096,
            within PROBE_F32_REL of the float64 plain version, and with its
            split-TF32 route's bound and share.  K17 (fused_step_skeleton) at
            bench.py's twins, 256x256 B 4096 float32 and B 8192 bf16, and
            both types at four ragged shapes, D 5 to 200, with an x' of
            their own (at scale 1: out within 1e-4, vmax within 1e-4 relative of its own
            out's scoring; bit-equal to a rerun; its bound: W.X once and
            out.x', though it redoes W.X for every tile as bench.py's does;
            its route's bound: the 4 N B D FLOPs it issues, three TF32
            products each in float32 and one in bf16; library_ms: the
            PyTorch chain w @ x, the gather-add, one mm and amax, which is
            what the plain version runs at these shapes),
            and one "attainable_pct" line (100 * skeleton ms / step ms) for
            K14 at B 4096 and 8192 and K3 at the 1M step.  Then their memory
            is handed back (gc, torch.cuda.empty_cache), as before the mesh
            phases;
3w. the SOM step kernels past 256 features (wide_d_phases: their feature
            passes of 256): K3, K13 and K14's main form (its bf16 batches
            too) at D 300 and 512, a bf16 codebook at 300, K14's stagger
            (bit-equal to its main form) and int8_win at 300, K5 (bit-equal
            to K3), K6, K7 (bit-equal to K chained K3 steps), K11 then K12
            (bit-equal to K3 on a shard) and K17 at 300 and 512, K3 and K6
            (sixteen 64-feature slabs) at 1024, each under its D <= 256
            gates at a small map; then
            phase 4w's shapes: K1 at its step (1024 x 16384 x 512, rerun,
            bit-equal to K2), K2 at its evaluation (100,000 x 16384 x 512,
            rerun) and K13 at its step (128x128, B 1024, D 512), under
            their D <= 256 gates; and K7's shared memory by the C layout's
            count (somvq_vmem_smem_bytes): up to D 128 the walk's CTA at
            every cluster size, past it whole rows of 16-row CTAs at B 256,
            within the card's opt-in at every D 1-1024;
4. e2e_128x128_100k  SOMTrainer.fit on a stream, then find_qerror(fast),
            through the kernels and through the plain versions: K13 per
            step (no K3 launch, the JAX trainer's choice); qerror within
            0.5% of the plain run and 2% of the JAX package's anchor; then
            with bf16=True, qerror under 1.1x the float32 run's;
4w. e2e_wide_128x128_D512  100,000 x 512 (blob_data, NumPy seed 44;
            205 MB on the device), 128x128 hexa gaussian, B 1024, randinit
            from CRandom(123): SOMTrainer.fit on the JAX trainer's choice
            (K13 at D 512, its feature passes), find_qerror(fast) (K2 at D
            512), through the kernels and through the plain versions;
            qerror within 1% of plain and below the random init's;
5. som_batch_step_128x128  a few unmasked two-kernel steps through
            models.fast.som_batch_step, against the plain run;
6. e2e_masked_128x128_100k  phase 4's run with missing components in
            every other chunk and weight= tokens (K13, re-seed and masked
            steps all run), then the masked qerror; within 1% of plain;
6a. e2e_som_online_64x64  the online scan, som_train(mode="fast"): a
            64x64 hexa gaussian random-init map over the first 20,000 of
            phase 4's rows, one sample per step (K1 at B 1), alpha 0.05,
            radius 16; then over the first 5,000 of phase 6's masked rows
            (K4 at B 1); each through the plain versions and again, qerror
            within 1% of plain, below the random-init qerror, the rerun
            bit-equal; samples/s;
6b. e2e_som_train_fast_128x128_100k  models.fast.som_train_fast on phase
            4's rows: 128x128 hexa gaussian random init, B 1024, rlen
            100,000 (97 steps of K1 + K5), radius 32; within 1% of plain,
            below random init, a rerun bit-equal;
6c. e2e_vfind_8x16x16  bench.py:prep_vfind's row: vfind_trials over 2048
            x 16 normal rows (default_rng(9)), 8 trials of a 16x16 hexa
            gaussian map, phases (2048, 0.05, 4.0) and (2048, 0.02, 2.0), B
            128 (K1 + K5 per trial and batch, K2 scores); each trial's qerror
            within 1% of the plain run's, the same best trial unless the
            plain run's two best are within 1%, trial 8 bit-equal to a
            one-trial call;
7. e2e_masked_64x64_100k  the grouped path: a 64x64 map on the 100k data
            with every other 16384-row chunk masked and weight= tokens, so
            clean groups (K1 + K7) alternate with dirty ones (K4 + K6 per
            batch); then the masked qerror; within 1% of plain;
8. e2e_256x256_1M    the 1M x 64 run of bench.py:run_e2e_1m_65k (K3 per
            step, the JAX trainer's choice there), qerror within 2% of the
            JAX package's anchor; then with stream_bf16=True, within 1% of
            it;
8a. e2e_qerror2       find_qerror2(mode="fast") (K1, K4 masked): phase
            4's codebook on its rows at radius 1 and 8, gaussian and as
            bubble, phase 6's masked codebook on its rows, and phase 8's on
            the 1M rows at radius 1 (timed, with the peak of allocated
            device memory); each within 0.1% of the plain run;
9. e2e_64x64_1M      the grouped path on the same 1M x 64 data: a 64x64
            map, B 512, 1953 steps in 62 K7 launches, then K2's qerror;
            also with vmem_steps=False (K13 per step) and through the plain
            versions; within 1% of both, and below 0.8x random init.
            e2e_64x64_1M_B4096: the same map at B 4096, radius 16, 244
            steps: K14 with the bf16 x-pattern and bf16 batches (the JAX
            trainer's choice); within 0.5% of the plain run;
10. e2e_masked_256x256_1M  the 1M run with every chunk masked (every step
            is the masked two-kernel step), then one masked winner search
            over 1M x 65536; within 1% of plain, and below 0.8x the
            random-init codebook's qerror.
11. e2e_olvq1_65536_1M  the LVQ family at bench.py:prep_olvq1's shape: a
            65,536-code LVQ codebook (D 64) drawn from 1M labelled vectors
            (32 centres, 8 classes), OLVQ1Trainer with B 1024 for one lap
            of 16384-row chunks (976 K1 steps, each with a segment sum),
            then accuracy(parity=False) over the 1M (K1); within 0.5 points
            of the plain run and above the initial codebook's accuracy; run
            again, codebook and accuracy bit-equal; then 40 olvq1 steps on
            the 1M Dataset with checkpoints every 16, and the same run
            resumed from step 32, codebook and alphas bit-equal;
12. e2e_lvq3_65536_1M   LVQTrainer("lvq3") from phase 11's codebook, alpha
            0.01, rlen 262,144 (256 K8 steps), then the accuracy; within
            0.5 points of the plain run; run again, bit-equal;
13. e2e_masked_lvq_4096_100k  the first 100k of phase 11's data with every
            other 16384-row chunk masked, a 4096-code codebook:
            OLVQ1Trainer (K1 clean, K4 masked batches), LVQTrainer("lvq2")
            (K8 clean, K9 masked), the masked accuracy (K4); within 0.5
            points of the plain run.
13c. e2e_lvq_knn_262144  (run after 13) the lvqexample chain's kNN tools
            on the first 262,144 of phase 11's rows: eveninit(mode="fast")
            for 4,096 codes at knn 5 (a 262,144^2 self-kNN: K10 on the
            reversed codebook), knn_accuracy, setlabel and elimin (K10),
            confusion_matrix(parity=False) (K1); against the plain run: the
            self-kNN lists equal except near-ties (every column's two
            neighbours within 1e-5 relative in float64; at most 0.1% of the
            rows), the correct masks and elimin's rows differing only there,
            eveninit's picks equal or parting first at a flipped row, both
            accuracies within 0.5 points; each call's wall;
13d. e2e_lvq_scans_4096  the per-sample scans from 13c's codebook:
            olvq1_train(mode="fast") 10,000 steps (K1 at B 1), lvq3_train
            10,000 from it (K8), lvq1_train and lvq2_train 2,500 steps each
            on phase 13's first masked chunk (K4, K9); each codebook's
            accuracy(parity=False) over the 262,144 rows within 0.5 points of
            the plain run, each codebook and olvq1's rates row by row within
            1e-5 of the plain run's on all but 1% of the rows (equal winners
            give equal bits), olvq1's accuracy above the eveninit codebook's,
            olvq1 and lvq3 rerun bit-equal (codebook, alphas); samples/s per
            scan.
13e. e2e_cli_fast  (run after 13d) the CLI's -fast tools through
            som_lvq_pak_torch.cli.main, in a temporary directory: on phase
            4's 100,000 x 64 rows written as text by the port's write_data,
            randinit 128x128 hexa gaussian (host), vsom -fast over 100,000
            samples at B 1024 (K1, K13), qerror -fast (K2) and -qetype 1
            (K1), vsom -fast -buffer 16384 over 32,768 samples with and
            without -bf16stream, vfind -fast (8 trials of 16x16 over 2048 x
            16 rows on stdin: K1 + K5, K2); on the first 65,536 of phase
            11's rows, labelled, eveninit -fast for 4,096 codes, olvq1 and
            lvq3 -fast over 65,536 samples (K1, K8, the segment sum),
            knntest, setlabel and elimin -fast (K10).  The plain run repeats
            the tools its gates read (vsom, vfind and the LVQ chain).  Each
            output file byte-equal to write_data of the same call through
            the Python API on the card, each printed qerror and knntest line
            the API's; vsom's qerror within 1% of the plain run's, the bf16
            stream within 1% of the float32 stream, vfind's best trial the
            plain run's unless its two best are within 1%, the olvq1, lvq3
            and knntest accuracies within 0.5 points, eveninit, setlabel and
            elimin apart only at near-ties (13c's rule); then `python -m
            som_lvq_pak_torch.cli qerror -fast` in a fresh process, which
            must print the in-process line, beside the walls of a bare
            interpreter and of the torch import, CUDA init and library load;
            each tool's wall split into its text read, the call and the
            write, the API twin's beside it; every read, write and chunk
            parse must go through the native engine ("native": true), and
            som.dat is read once more with the engine and once with
            SOMVQ_NATIVE=0 (the Python parser), bit-equal.  Then
            e2e_sammon_fast_128x128: sammon_fast on the trained 16,384-unit
            map for 100 iterations (the error also read at 20), rerun
            bit-equal, the mapping error (float64 on the card) below the
            initial layout's; its wall and peak memory.
13f. e2e_example_large_som  som_lvq_pak_torch.examples.large_som at the JAX
            example's defaults: 100,000 x 64, 128x128, B 1024, two phases of
            20 laps, Sammon of 512 codes (the fused step fused_step_choice
            picks, K13 here; K1 prologue; K2 qerror; sammon_fast), then
            through the plain versions on the card; check_summary, each
            qerror point within 1% of the plain run's.
13g. e2e_example_streaming_som  examples.streaming_som at 1M x 64, 128x128,
            B 1024, buffer 16,384, one lap, on a file its generate_file
            writes (outside the fit's wall); the held-out qerror falls and
            is within 1% of the plain run's, every chunk parse on the
            engine; a 262,144-row streamed fit with the engine on and with
            SOMVQ_NATIVE=0, the codebooks bit-equal; a 16-step fit under
            utils.progress.trace, whose exported trace must name the
            fused-step kernel.
13a. e2e_int8_win_256x256_B4096  som_lvq_pak_torch.tools.int8_step_ab: the
            step times of the float32 (K14's main form), int8_win and stagger
            (K14's walk) chains with K17 beside them, then 64 training steps
            of each from K1's winners and the qerror over 262,144 samples
            (K2); int8_win's qerror within 1% of float32's, the stagger
            codebook bit-equal to the float32 chain's.
13b. int8_probe  som_lvq_pak_torch.tools.int8_probe: the bf16/int8 library
            rates at 4096^3 and K15 against K16 at 65536 x 64 x 4096.

The mesh phases (14-19) each spawn a world of processes on this one card
(parallel.mesh.spawn: one process per mesh position, a file:// rendezvous,
gloo, since NCCL takes one card per rank; collectives staged through
pinned host memory) and print the backend, the layout, train_s, the
quality number against its gate and each rank's launch counts.  Each rank
sets its counters to 0 before its fit and reads them after; the gate is
the single-device port run on the same data in this script:

14. e2e_mesh_tp_256x256_1M  (data 1, model 2) SOMTrainer(mesh=) on phase
            8's 1M data and map as a Dataset: the pure-TP fused step (K3
            with each shard's unit offset, K1 prologue); qerror within 1% of
            the single-device Dataset run, the codebook bit-equal to it;
15. e2e_mesh_mixed_256x256_100k  (data 2, model 2) first one mixed step
            on the whole 256x256 map against K3 on the same inputs (codes
            within 1e-5, winners equal except at near-ties); then the drift
            chains, 24 steps over the first 100k rows in order: K3 on one
            card, and the mixed step taking its own winners (free) or the K3
            chain's (forced, within DRIFT_FORCED_ATOL of the K3 chain);
            then the trainer on the first 100k rows: the mixed step (K11,
            the data-axis sum in two row segments, K12); qerror within 1% of
            the single-device run, the codebook's mean and max distance from
            it within DRIFT_RATIO times those of the single-device run on
            the data moved up by one ulp (near-tie winner flips carry any
            rounding difference over the map);
16. e2e_mesh_masked_stream_128x128_100k  (data 2, model 1) phase 6's
            masked, weighted stream: the two-pass step (K1 clean, K4 masked
            batches); qerror within 1% of phase 6;
17. e2e_mesh_lvq_65536  (data 2, model 2, in phase 15's world) phase 11's
            data and codebook: OLVQ1Trainer(mesh=) over 262,144 streamed
            rows (K1 at B 512 x 32768 per rank), then LVQTrainer("lvq3",
            mesh=) from its codebook (K10, k = 2); each accuracy over the 1M
            within 0.5 points of the single-device runs on the same stream.
18. mesh_dryrun  som_lvq_pak_torch.dryrun.dryrun_multichip(4): every
            sharded path of __graft_entry__.py's dryrun in a (data 2, model
            2) world, in its order, with its checks and tolerances (the
            two-pass step at overlap_chunks 1 and 4, olvq1, the dim-sharded
            and ring winners, an 8-step train against the one-device
            som_batch_step, the mesh checkpoint resume, the fused TP step,
            the mixed step, sharded lvq3, ClassBlockedOLVQ1); then entry()
            once (K1 + K5) beside its plain run; the summary line and each
            rank's launches; each rank must launch K1, K3, K5, K10, K11, K12
            and the segment sum;
19. e2e_mesh_overlap_256x256  (data 2, model 2) the north-star shape:
            bench.py's e2e_256x256_1M data (default_rng(7)), its CRandom(123)
            random-init 256x256 codebook, 16 two-pass steps of
            make_sharded_som_train_step(gaussian=True) on its first 16
            batches of 4096 at the trainer's alpha and radius schedule,
            after an untimed pass at overlap_chunks 1, 4, 4, 1, 1, 4, 4 and
            1 (each run's slowest rank's ms per step by CUDA events, and the
            median per k; over gloo on one card an equality check, not an
            overlap measurement, which the line says); gates: the k 1 and
            k 4 codebooks, the runs and every step's winners
            (sharded_winner_search against chunked_winner_search in 4
            pieces) bit-equal; each step within 1e-4 of the one-device
            som_batch_step (K1 + K5) from the same codebook; the qerror over
            the 65,536 rows falling.  The free one-device chain (16
            som_batch_steps from the start) is printed beside it: near-tie
            winner flips carry its rounding difference over the map, as
            phase 15's drift chains show.

With four cards, --mesh runs phases 18 and 19 over NCCL, one card per rank,
and e2e_mesh_multihost_2x2: two torchrun "hosts" on the machine
(--nnodes 2 --nproc-per-node 2, node ranks 0 and 1, one rendezvous on
127.0.0.1, CUDA_VISIBLE_DEVICES 0,1 and 2,3) running `python -m
som_lvq_pak_torch.dryrun multihost`, whose ranks start the world with
initialize_distributed() and no arguments (NCCL on cuda:LOCAL_RANK) and
run tests/multihost_worker.py's steps (the SOM and olvq1 steps on the batch
each host streamed half of, a 6-step streamed train resumed from rank 0's
checkpoint bit-equal, the fused TP and mixed steps against one-device K3);
the SOM and olvq1 steps are held to the one-device port at 1e-5 (alphas
1e-6).  With fewer cards one "four_card_runs_not_run" line says what did
not run and why.

K8/K9 (dist_top2, plain and masked) are held against their plain version in
phase 3 at the LVQ step's shape (B 1024 x 65536 x 64), the masked LVQ
cell's B 1024 x 4096, at 1000 x 999 x 5, with every code twice (exact ties:
both indices equal the plain version's), at N = 2, D 37 and D 130, and at
the per-sample lvq2/lvq3 scans' step, B 1 x 4096 x 64 (K9 once with its one
row partly masked, once with it fully masked); K9 with p = 0.1 and fully
masked rows; each shape run twice (bit-equal), the best
pair bit-equal to the same sums' argmin (K1's for K8, K4's for K9) on the
same inputs, K8's pairs bit-equal to K10's at k = 2 (one walk),
with its route's bound (6 B N D; 10 B N D for K9).  K10
(dist_topk, K1's wgmma walk with a fold of KM pairs) at the mesh step's
shapes (B 512 and 1024 x 32768 x 64, k = 2; the record at B 512 timed over
50 back-to-back launches), K8's shapes at k = 2 (its pairs K8's bit for
bit), the mesh rank's shape at k = 4, 8 and 16 (one "k10_km" line: the
time of each list width KM beside its ptxas registers and spills), small
shapes at k = 1, 3, 5 and 16, every code twice, D 37, 130 and 300 at k 3,
5, 8 and 16; each run twice (bit-equal), its column 0 K1's (value, index)
bit for bit, with its route's bound (6 B N D); K10 in the reference tie order
(dist_topk_reference: K10 on the reversed codebook, the host tools' kNN) at
B 1024 x 65536 x 64, k 5, and with every code twice: its indices the plain
reference_ties path's (exactly with ties, the later copy first), its values
K10's in file order bit for bit, and the two halves of the codebook merged
and four query chunks bit-equal to the whole run; K11 (som_neighborhood_accumulate) at a
32768-row shard of the 256x256 map (offset 32768, B 2048), gaussian and
bubble, hexa and rect, scalar and per-sample alpha, each run twice
(bit-equal), with its route's bound; K12 (som_blend_winner) at that shard
with B' 2048 and 4096 and with every row twice, each run twice (bit-equal),
with its route's bound (6 n_local B' D); K3 on each half of the 256x256 map
with its unit offset against the unsharded run, and K11 then K12 on one
half equal to that half's K3 step bit for bit (codebook, values and
winners); K1 at the mesh's B 512 x 32768.

Each main-path run (4-19) sets every launch counter to 0 before it and
reads them after: each kernel of that path must have launched, and the
plain runs must launch none.  Then a "wall" line with the script's
seconds so far, a line with the segment sum's record
(a kernel of the LVQ paths that ports no TPU kernel), one line with every
TPU kernel's record (launches summed over those runs, over every rank), the
nvidia-smi line, and last {"ok": true, "device": {...}}.  Any failure, a rank that fails or
a world past its time limit included, ends the run non-zero first.

Nothing here imports jax or the JAX package: the host types (Dataset,
Topology, CRandom) are the port's own.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

# quality anchors of the JAX package on these runs (BENCH_r05.json)
ANCHOR_128 = 7.7118
ANCHOR_1M = 7.754

# one H100 SXM's published peaks (NVIDIA's data sheet): FP32 outside the
# tensor cores, dense TF32, BF16 and INT8 on the tensor cores, and device
# memory bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_S = 3.35e12

# the kernels whose products run on the tensor cores as split TF32 on
# mma.sync: K3 and K17 past D 128 (their one instantiation each, NT 32),
# K12 (K3's blend-and-winner half), K13 (K3's body with the separable W)
# and K14's main form (K13's body; one TF32 product under batch_bf16) past
# D 128, K14's walk (stagger and int8_win: the same body's chunk functions;
# int8_win's winners on int8 mma.sync, the IMMA of INT8_MMA_KERNELS), K16
# (the mma.sync winner walk) and, past D 128, K7 (K3's step body on the
# resident codebook) and K12
SPLIT_TF32_KERNELS = ("som_fused_step_kernel",
                      "som_fused_factored_kernel",
                      "som_fused_factored_chunked_tc_kernel",
                      "f32_winner_probe_kernel", "fused_skeleton_kernel",
                      "som_vmem_steps_kernel", "som_blend_winner_kernel",
                      "som_fused_chunked_stagger_kernel",
                      "som_fused_chunked_int8_kernel")
INT8_MMA_KERNELS = ("som_fused_chunked_int8_kernel",)
# K15's int8 products on warpgroup wgmma (IGMMA in the SASS)
INT8_WGMMA_KERNELS = ("int8_winner_probe_kernel",)
# K1 and K2 (one walk, two names), K8 and K10 (that walk with a top-2 and a
# top-k fold), K4 (the walk with the keep contraction beside it) and K9
# (K4's with the top-2 fold), K3, K13, K14's main form and K17 up to D 128
# (their Hopper walk, csrc/fused_step_sm90.cuh), K6, K5 and K11 (its
# update on one feature slab a CTA, at any D), and K7 and K12 up to D 128
# (the walk's steps on resident rows, and its blend and winners):
# split-TF32 products on warpgroup wgmma (HGMMA, and no HMMA), fed by TMA
# like K15 (UTMALDG)
TF32_WGMMA_KERNELS = ("dist_argmin_kernel", "dist_argmin_t_kernel", "top2_sm90_kernel",
                      "dist_topk_sm90_kernel",
                      "masked_argmin_sm90_kernel", "masked_top2_sm90_kernel",
                      "som_fused_step_sm90_kernel", "som_fused_factored_sm90_kernel",
                      "som_chunked_sm90_kernel",
                      "fused_skeleton_sm90_kernel", "som_update_masked_sm90_kernel",
                      "som_update_sm90_kernel", "som_accum_sm90_kernel",
                      "som_vmem_steps_sm90_kernel", "som_blend_winner_sm90_kernel")
# the kernels whose ptxas report must show no spill and no serialized
# wgmma (K5 and K11, on K3's update walk; K10, on K8's walk; K13 and K14's
# main form, instances of one separable walk; K7 and K12 on K3's walk)
CLEAN_PTXAS_KERNELS = ("som_update_sm90_kernel", "som_accum_sm90_kernel",
                       "dist_topk_sm90_kernel", "som_fused_factored_sm90_kernel",
                       "som_chunked_sm90_kernel", "som_vmem_steps_sm90_kernel",
                       "som_blend_winner_sm90_kernel")
TMA_KERNELS = TF32_WGMMA_KERNELS + INT8_WGMMA_KERNELS

# K16 on normal float32 inputs: within this relative gap of the float64
# maximum (split TF32 is about 2^-21 relative per product, float32 sums of 64)
PROBE_F32_REL = 1e-5


T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line of the run's record, with its seconds since the script
    started (at_s), so that a phase's share of the wall can be read."""
    print(json.dumps({"phase": phase, **kw, "at_s": time.perf_counter() - T_START}),
          flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds per call of fn() by CUDA events, after a warm-up."""
    import torch

    from som_lvq_pak_torch.tools.timing import mean_ms

    return mean_ms(fn, torch.device("cuda"), iters)


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS,
          int8_ops: float = 0.0, route_flops: float = None) -> dict:
    """The least time the card could take for a kernel's work: its FLOPs at
    the peak of their operand type (FP32 unless stated; `int8_ops` more at
    the INT8 peak) or its bytes (each input read once, each output written
    once) at the memory rate, whichever is larger.  With `route_flops`, the
    TF32 FLOPs a tensor-core kernel issues (K1-K3, K5, K7, K8, K10-K13:
    three TF32 products per float32 product, 3 x the FLOPs; K6: three for
    W.(X o K), two for W.K; K4 and K9: three for (x keep).m, two for
    keep.(m o m); K14 under batch_bf16: one), also the bound of that route,
    route_bound_ms:
    those FLOPs at the TF32 peak (and `int8_ops` at the INT8 peak: int8_win's
    winners run on int8 mma.sync), or the bytes.  library_ms is null here: a
    phase sets it where one PyTorch call computes the kernel's function."""
    i_ms = 1e3 * int8_ops / PEAK_INT8_OPS
    f_ms = 1e3 * flops / peak + i_ms
    b_ms = 1e3 * nbytes / PEAK_BYTES_S
    rec = dict(bound_ms=max(f_ms, b_ms),
               bound_by="operations" if f_ms >= b_ms else "bytes",
               library_ms=None)
    if route_flops is not None:
        rec["route_bound_ms"] = max(1e3 * route_flops / PEAK_TF32_FLOPS + i_ms, b_ms)
    return rec


def route_pct(rec) -> dict:
    """The roofline share against the route's bound, for a record with a
    route_bound_ms."""
    return dict(route_pct=100.0 * rec["route_bound_ms"] / rec["ms"])


def library_winners(x, codes, form, k=2, mask=None):
    """One PyTorch call chain per row chunk computing a winner kernel's
    function, timed beside it as its library_ms (the port never calls it):
    ||m||^2 - 2 x.m by torch.addmm, then argmin ("min", K1), topk(k,
    largest=False) ("topk", K8 and K10), or x.m - ||m||^2 / 2 then argmax
    ("max", K2); with a `mask` (K4, K9) the partial distance is
    torch.addmm(keep @ (m o m)^T, x keep, m^T, alpha=-2); rows in the plain
    versions' chunks (4096 against 65,536 codes), under fp32_matmul()."""
    import torch

    from som_lvq_pak_torch.ops.dist_argmin import _rows_per_chunk

    m2 = (codes * codes).sum(-1)
    keep = None if mask is None else (mask == 0).float()
    step = _rows_per_chunk(codes.shape[0])
    out = []
    for s in range(0, x.shape[0], step):
        xc = x[s:s + step]
        if form == "max":
            out.append(torch.addmm(-0.5 * m2, xc, codes.T).argmax(1))
            continue
        if keep is None:
            d = torch.addmm(m2, xc, codes.T, alpha=-2)
        else:
            kc = keep[s:s + step]
            d = torch.addmm(kc @ (codes * codes).T, xc * kc, codes.T, alpha=-2)
        out.append(d.argmin(1) if form == "min" else d.topk(k, largest=False))
    return out


def kernel_base(name: str, bases):
    """The longest of `bases` within the mangled `name` (K8's
    top2_sm90_kernel lies within K9's masked_top2_sm90_kernel), or None."""
    return max((b for b in bases if b in name), key=len, default=None)


def sass_mma(dump: dict, kernels=SPLIT_TF32_KERNELS, op: str = "HMMA") -> dict:
    """Tensor-core use of `kernels` (the split-TF32 ones unless given), read
    from the built library's SASS (`dump`: tools.sass_diff.sass of the
    library, by cuobjdump; ncu does not run on every host): the `op`
    instructions (HMMA; IMMA for the int8 mma.sync products, IGMMA for the
    int8 wgmma ones) in each of their instantiations, by mangled name from
    the kernel's name on.  Raises if an instantiation has none, or if none
    is found."""
    counts = {}
    for name, insns in dump.items():
        base = kernel_base(name, kernels)
        if base:
            counts[name[name.index(base):]] = sum(op in i for i in insns)
    for base in kernels:
        found = {k: v for k, v in counts.items() if k.startswith(base)}
        if not found or not all(found.values()):
            raise AssertionError(f"{base}: no {op} instructions in the SASS: {found}")
    return counts


def sass_none(dump: dict, kernels, op: str) -> dict:
    """The `op` instructions in each instantiation of `kernels`, which must
    have none (K1's, K2's, K8's and K4's HMMA: their products run on
    wgmma); raises
    otherwise, or if no instantiation is found."""
    counts = {}
    for name, insns in dump.items():
        base = kernel_base(name, kernels)
        if base:
            counts[name[name.index(base):]] = sum(op in i for i in insns)
    if not counts or any(counts.values()):
        raise AssertionError(f"{kernels}: {op} instructions in the SASS: {counts}")
    return counts


def no_dp4a(dump: dict) -> int:
    """The IDP4A instructions (__dp4a on CUDA cores) in the library's SASS
    (`dump`): none may be left, every int8 product runs on the tensor cores;
    raises otherwise."""
    found = {name: n for name, insns in dump.items()
             if (n := sum("IDP4A" in i for i in insns))}
    if found:
        raise AssertionError(f"IDP4A in the library: {found}")
    return 0


def template_args(name: str, base: str) -> list:
    """The template arguments of kernel `base` in the mangled `name`:
    integers and bools as their values, float as f32, __nv_bfloat16 (or a
    substitution, which among these kernels' arguments can only repeat it)
    as bf16."""
    import re

    i = name.find(base + "I")
    s, out = (name[i + len(base) + 1:] if i >= 0 else "E"), []
    while s and s[0] != "E":
        m = re.match(r"L[ib](\d+)E|f|(\d+)|S\w*?_", s)
        if m is None:
            break
        if m.group(1) is not None:
            out.append(m.group(1))
        elif m.group(0) == "f":
            out.append("f32")
        elif m.group(2) is not None:
            n0 = len(m.group(2))
            out.append("bf16" if "bfloat16" in s[n0:n0 + int(m.group(2))] else
                       s[n0:n0 + int(m.group(2))])
            s = s[n0 + int(m.group(2)):]
            continue
        else:
            out.append("bf16")
        s = s[m.end():]
    return out


def ptxas_report(log: str, bases=("dist_argmin_kernel", "dist_argmin_t_kernel",
                                  "split_codes_kernel", "top2_sm90_kernel",
                                  "masked_argmin_sm90_kernel",
                                  "split_masked_codes_kernel",
                                  "dist_topk_sm90_kernel", "som_blend_winner_kernel",
                                  "masked_top2_sm90_kernel", "som_update_sm90_kernel",
                                  "som_accum_sm90_kernel",
                                  "som_fused_chunked_stagger_kernel",
                                  "som_fused_chunked_int8_kernel",
                                  "int8_winner_probe_kernel",
                                  "som_fused_step_sm90_kernel",
                                  "som_fused_factored_sm90_kernel",
                                  "som_chunked_sm90_kernel",
                                  "fused_skeleton_sm90_kernel",
                                  "split_sm90_kernel", "som_update_masked_sm90_kernel",
                                  "split_masked_batch_kernel",
                                  "som_vmem_steps_sm90_kernel",
                                  "som_blend_winner_sm90_kernel",
                                  "split_steps_kernel")) -> dict:
    """Registers and spill bytes of each instantiation of the kernels named
    (K1, K2 and their prologue, K8, K4 and its prologue, K10, K12, K9, K5, K11,
    K14's walk, K15, K3's, K13's, K14's and K17's Hopper walk and its prologue, and
    K6 and its prologue unless given), and "wgmma_serialized" where ptxas
    reports that it serialized the
    function's wgmma (its C7518 performance note), from nvcc's -Xptxas -v
    report (the build's log; K4's registers are its launch's 168 a thread,
    before its warpgroups' setmaxnreg split): {"name<args>":
    {"registers", "spill_stores", "spill_loads"}}."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"wgmma.mma_async instructions are serialized.* function '(\w+)'", line)
        if m:
            base = kernel_base(m.group(1), bases)
            if base:
                targs = template_args(m.group(1), base)
                name = base + (f"<{','.join(targs)}>" if targs else "")
                out.setdefault(name, {})["wgmma_serialized"] = True
            continue
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
            base = kernel_base(name, bases)
            fn = None
            if base:
                targs = template_args(name, base)
                fn = base + (f"<{','.join(targs)}>" if targs else "")
                out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def clean_ptxas(report: dict, bases=CLEAN_PTXAS_KERNELS) -> None:
    """Raise unless each instantiation of `bases` in ptxas_report's
    `report` spills nothing and keeps its wgmma unserialized (no C7518
    note), and each base has one; an empty report (a library built earlier
    whose build kept no log) checks nothing."""
    if not report:
        return
    found = {n: v for n, v in report.items() if n.split("<")[0] in bases}
    bad = {n: v for n, v in found.items()
           if v.get("wgmma_serialized") or v.get("spill_stores", 0)
           or v.get("spill_loads", 0)}
    missing = [b for b in bases if not any(n.split("<")[0] == b for n in found)]
    if bad or missing:
        raise AssertionError(f"ptxas: spilled or serialized {bad}, not found {missing}")


def check_winners(name, x, codes, ik, ip, rel=1e-5, mask=None, bf16_score=False,
                  codes_plain=None):
    """Kernel and plain winners must agree except where the two candidate
    rows' distances (over the unmasked components) differ by less than
    `rel` (relative, in float64).  With `codes_plain`, the plain run's own
    codebook, each side's winner is scored on its own codebook, and a flip
    fails where either side's winner is worse than the other's by `rel`:
    two codebooks equal to 1e-5 whose rows round to different bf16
    neighbours may then rank a near-tie each its own way.  With
    `bf16_score` the distance is the one the batch_bf16 winners rank by:
    ||x'||^2 - 2 x'.m' + ||m||^2 with x' and m' rounded to bf16 and the norm
    from the float32 row."""
    import torch

    bad = (ik.long() != ip.long()).nonzero()[:, 0]
    if bad.numel():
        xb = x[bad].double()
        keep = 1.0 if mask is None else (mask[bad] == 0).double()
        if bf16_score:
            r = lambda t: t.to(torch.bfloat16).double()  # noqa: E731
            xr = r(x[bad])

            def dist(cb, rows):
                c = cb[rows.long()]
                return ((xr * xr).sum(-1) - 2.0 * (xr * r(c)).sum(-1)
                        + (c.double() ** 2).sum(-1))
        else:
            def dist(cb, rows):
                return (((xb - cb[rows.long()].double()) ** 2) * keep).sum(-1)
        da, db = dist(codes, ik[bad]), dist(codes, ip[bad])
        if codes_plain is None:
            gap = (da - db).abs() / torch.clamp(torch.maximum(da, db), min=1e-30)
        else:  # each side's excess over the other's winner, on its own rows
            pa, pb = dist(codes_plain, ik[bad]), dist(codes_plain, ip[bad])
            gap = torch.maximum((da - db) / torch.clamp(torch.maximum(da, db), min=1e-30),
                                (pb - pa) / torch.clamp(torch.maximum(pa, pb), min=1e-30))
        worst = float(gap.max())
        if worst >= rel:
            raise AssertionError(f"{name}: {bad.numel()} winners differ, "
                                 f"largest relative gap {worst:.3g} >= {rel}")
    return int(bad.numel())


def random_mask(g, B, D, p, full_rows=True):
    """(B, D) uint8 mask on the card: each component masked with
    probability p, and (with full_rows) every 97th row masked entirely."""
    import torch

    m = (torch.rand((B, D), generator=g, device="cuda") < p).to(torch.uint8)
    if full_rows:
        m[::97] = 1
    return m


def phase_distance(name, kernel, plain, B, N, D, seed, dup=False, iters=10,
                   mask_p=None, library=None, rerun=False, twin=None, full_rows=True):
    """One winner kernel against its plain version; with mask_p, the masked
    kernel on a random mask: fully masked rows (every 97th, the first
    included, unless full_rows is False) must get index 0, value 0.
    With `library` (a library_winners form) its library_ms; with `rerun` the
    kernel runs twice on the same inputs and must give the same values and
    winners bit for bit; with `twin` (K2 beside K1) that kernel must give
    the same values and winners bit for bit on the same inputs."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, D), generator=g, device="cuda")
    if dup:  # every row three times: the lowest index must win exact ties
        base = torch.randn((N // 3, D), generator=g, device="cuda")
        codes = torch.cat([base, base, base]).contiguous()
    else:
        codes = torch.randn((N, D), generator=g, device="cuda")
    args = (x, codes) if mask_p is None else (x, codes,
                                              random_mask(g, B, D, mask_p, full_rows))
    vk, ik = kernel(*args)
    vp, ip = plain(*args)
    torch.cuda.synchronize()
    if rerun:
        v2, i2 = kernel(*args)
        if not (torch.equal(vk, v2) and torch.equal(ik, i2)):
            raise AssertionError(f"{name}: two runs on the same inputs differ")
    if twin is not None:
        vt, it = twin(*args)
        if not (torch.equal(vk.view(torch.int32), vt.view(torch.int32))
                and torch.equal(ik, it)):
            raise AssertionError(f"{name}: not bit-equal to {twin.__name__} on the "
                                 "same inputs")
    if dup and int(ik.max()) >= N // 3:
        raise AssertionError(f"{name}: a duplicate row beat its first copy")
    n_diff = check_winners(name, x, codes, ik, ip, mask=args[2] if mask_p else None)
    if not torch.allclose(vk, vp, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{name}: values differ by {float((vk - vp).abs().max())}")
    if mask_p is not None and full_rows:
        empty = (args[2] != 0).all(dim=1)
        if not bool(empty.any()) or bool((ik[empty] != 0).any()) \
                or bool((vk[empty] != 0).any()):
            raise AssertionError(f"{name}: a fully masked row did not get index 0, value 0")
    # (B, D) samples and (N, D) codes in, (B,) value and index out; 2BND
    # FLOPs, 4BND with the mask's keep.(m o m) contraction
    masked = mask_p is not None
    flops = (4 if masked else 2) * B * N * D
    # the TF32 products issued: three per FP32 product; K4's keep.(m o m)
    # two (keep is exact in TF32), so 10 B N D under a mask
    route = 10 * B * N * D if masked else 3 * flops
    rec = dict(kernel=name, shape=[B, N, D], dup=dup, mask_p=mask_p,
               winners_differ=n_diff, max_abs_err=float((vk - vp).abs().max()),
               **({"bit_equal_rerun": True} if rerun else {}),
               **({} if twin is None else {"bit_equal_to": twin.__name__}),
               ms=cuda_ms(lambda: kernel(*args), iters),
               plain_ms=cuda_ms(lambda: plain(*args), iters),
               **bound(flops, 4 * (B * D + N * D) + masked * B * D + 8 * B,
                       route_flops=route))
    if "route_bound_ms" in rec:
        rec.update(route_pct(rec))
    if library is not None:
        rec["library_ms"] = cuda_ms(lambda: library_winners(
            x, codes, library, mask=args[2] if masked else None), iters)
    emit("kernels", **rec)
    return rec


def phase_split_codes(N, D, seed, iters=10, masked=False):
    """K1's and K2's prologue (ops.dist_argmin.split_codes), or with `masked`
    K4's (split_masked_codes), against its plain version on rows over six
    decades of scale: hi, lo and ||m||^2 (K4's: hi, lo and m o m's hi and lo)
    bit for bit (the plain version re-enacts the kernel's order of the
    sums), run twice (bit-equal).  Its bound: the codebook read once, its
    (N, Dp) arrays and m2 written once.  ms is the wrapper's call (its
    outputs allocated each time, as K1's, K2's and K4's calls allocate their
    scratch); launch_ms the kernel's C entry alone into the same outputs,
    back to back: the device's time where the host's per-call work is
    shorter."""
    import torch

    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.ops import dist_argmin as da

    fn, plain, name = ((da.split_masked_codes, da.split_masked_codes_plain,
                        "split_masked_codes") if masked else
                       (da.split_codes, da.split_codes_plain, "split_codes"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    scale = 10.0 ** (6.0 * torch.rand((N, 1), generator=g, device="cuda") - 3.0)
    codes = torch.randn((N, D), generator=g, device="cuda") * scale
    got, again, want = fn(codes), fn(codes), plain(codes)
    torch.cuda.synchronize()
    label = f"{name} {N}x{D}"
    if not all(bits_equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two runs on the same inputs differ")
    if not all(bits_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: not bit-equal to {plain.__name__}")
    Dp = got[0].shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    # written: hi, lo (N, Dp) and m2 (N,); K4's four (N, Dp) arrays
    written = 16 * N * Dp if masked else 8 * N * Dp + 4 * N
    rec = dict(kernel=name, shape=[N, D], Dp=Dp, bit_equal_plain=True,
               bit_equal_rerun=True, max_abs_err=0.0,
               ms=cuda_ms(lambda: fn(codes), iters),
               launch_ms=cuda_ms(lambda: _build.call(
                   f"somvq_{name}", codes.data_ptr(), N, D, Dp,
                   *(t.data_ptr() for t in got), stream), 10 * iters),
               plain_ms=cuda_ms(lambda: plain(codes), iters),
               **bound((1 if masked else 2) * N * D, 4 * N * D + written))
    emit("kernels", **rec)
    return rec


def phase_top2(name, kernel, plain, B, N, D, seed, dup=False, iters=10,
               mask_p=None, library=False, twin=None, full_rows=True, topk_twin=False):
    """K8 (or K9 with mask_p) against the plain top-2: both winners equal
    except at near-ties, values within 1e-4.  With `dup` every code is there
    twice: each sample's pair is a row and its copy, exactly the plain
    version's indices.  A fully masked row (every 97th, the first included,
    unless full_rows is False) must get (0, 0, 0, 1).  With
    `library`, the library_ms of addmm then topk(2).  With `twin` (K1 beside
    K8, K4 beside K9: the same scores each) the kernel runs twice on the same
    inputs, bit-equal, its best pair must be the twin's (value, index) bit
    for bit, and the record carries its split-TF32 route's bound (6 B N D
    TF32 FLOPs; 10 B N D under a mask, keep.(m o m) by two products) and
    share.  With `topk_twin` (K8) both pairs must be K10's (dist_topk at
    k = 2, the mma.sync walk) bit for bit."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, D), generator=g, device="cuda")
    if dup:
        base = torch.randn((N // 2, D), generator=g, device="cuda")
        codes = torch.cat([base, base]).contiguous()
    else:
        codes = torch.randn((N, D), generator=g, device="cuda")
    mask = None if mask_p is None else random_mask(g, B, D, mask_p, full_rows)
    args = (x, codes) if mask is None else (x, codes, mask)
    k = kernel(*args)
    p = plain(*args)
    torch.cuda.synchronize()
    if twin is not None:
        again = kernel(*args)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(k, again)):
            raise AssertionError(f"{name}: two runs on the same inputs differ")
        vt, it = twin(*args)
        if not (torch.equal(k[0].view(torch.int32), vt.view(torch.int32))
                and torch.equal(k[1], it)):
            raise AssertionError(f"{name}: the best pair is not {twin.__name__}'s "
                                 "(value, index) bit for bit")
    if topk_twin:
        from som_lvq_pak_torch.ops.dist_topk import dist_topk

        vk, ik = dist_topk(x, codes, 2)
        if not all(bits_equal(vk[:, c], k[2 * c]) and torch.equal(ik[:, c], k[2 * c + 1])
                   for c in (0, 1)):
            raise AssertionError(f"{name}: the pairs are not dist_topk's at k = 2 bit for bit")
    n_diff = sum(check_winners(f"{name} {w}", x, codes, k[j], p[j], mask=mask)
                 for w, j in (("best", 1), ("second", 3)))
    err = max(float((k[j] - p[j]).abs().max()) for j in (0, 2))
    for j in (0, 2):
        if not torch.allclose(k[j], p[j], rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{name}: values differ by {err}")
    if dup:
        half = codes.shape[0] // 2
        if not (torch.equal(k[1], p[1]) and torch.equal(k[3], p[3])):
            raise AssertionError(f"{name}: exact ties resolved unlike the plain version")
        rest = torch.ones(B, dtype=torch.bool, device="cuda") if mask is None \
            else ~(mask != 0).all(dim=1)
        if bool((k[1][rest] >= half).any()) or \
                not torch.equal(k[3][rest].long(), k[1][rest].long() + half):
            raise AssertionError(f"{name}: a copy beat its first row")
    if mask is not None and full_rows:
        empty = (mask != 0).all(dim=1)
        got = [t[empty] for t in k]
        if not bool(empty.any()) or any(bool((t != want).any())
                                        for t, want in zip(got, (0, 0, 0, 1))):
            raise AssertionError(f"{name}: a fully masked row did not get (0, 0, 0, 1)")
    # (B, D) samples and (N, D) codes in, two (B,) values and indices out;
    # 2BND FLOPs, 4BND with the mask's keep.(m o m) contraction
    masked = mask is not None
    N = codes.shape[0]
    rec = dict(kernel=name, shape=[B, N, D], dup=dup, mask_p=mask_p,
               full_rows=mask is not None and full_rows,
               winners_differ=n_diff, max_abs_err=err,
               **({} if twin is None else {"bit_equal_rerun": True,
                                           "best_bit_equal_to": twin.__name__}),
               **({"pairs_bit_equal_to": "dist_topk k=2"} if topk_twin else {}),
               ms=cuda_ms(lambda: kernel(*args), iters),
               plain_ms=cuda_ms(lambda: plain(*args), iters),
               **bound((4 if masked else 2) * B * N * D,
                       4 * (B * D + N * D) + masked * B * D + 16 * B,
                       route_flops=None if twin is None
                       else (10 if masked else 6) * B * N * D))
    if "route_bound_ms" in rec:
        rec.update(route_pct(rec))
    if library:
        rec["library_ms"] = cuda_ms(lambda: library_winners(x, codes, "topk", 2, mask=mask),
                                    iters)
    emit("kernels", **rec)
    return rec


def phase_k1_shards(B, N, D, split, seed):
    """K1 on the whole codebook against K1 on its two shards [0, split) and
    [split, N) (`split` not a multiple of the 64-row tile), merged by the
    sharded winner's rule (parallel.sharded._gather_min: the smaller value,
    the lower global index among equal ones): the values bit-equal, and the
    winners equal wherever the two shards' candidates differ in value.  A
    row's partial distance does not depend on the tile or split that holds
    it, so the values agree; where two candidates' partials differ by less
    than the rounding of adding ||x||^2, their values tie and the sharded
    rule takes the lower index, the whole run the lower partial."""
    import torch

    from som_lvq_pak_torch.ops.dist_argmin import dist_argmin

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, D), generator=g, device="cuda")
    codes = torch.randn((N, D), generator=g, device="cuda")
    vw, iw = dist_argmin(x, codes)
    va, ia = dist_argmin(x, codes[:split].contiguous())
    vb, ib = dist_argmin(x, codes[split:].contiguous())
    ib = ib + split
    vals = torch.stack([va, vb])
    best = vals.min(0).values
    cand = torch.where(vals == best[None, :], torch.stack([ia, ib]),
                       torch.iinfo(torch.int32).max)
    ish = cand.min(0).values
    torch.cuda.synchronize()
    name = f"dist_argmin {B}x{N}x{D} on shards [0, {split}), [{split}, {N})"
    if not torch.equal(vw.view(torch.int32), best.view(torch.int32)):
        raise AssertionError(f"{name}: the shard min's values differ from the whole run's")
    flip = iw != ish
    if bool((va[flip] != vb[flip]).any()):
        raise AssertionError(f"{name}: winners differ where the shards' values do not tie")
    emit("kernels", kernel=name, values_bit_equal=True,
         winners_differ_at_value_ties=int(flip.sum()))


def bf16_ulp_close(got, want, atol=1e-5) -> bool:
    """Two bf16 codebooks from float32 blends equal to `atol`: each entry
    within one bf16 ulp (<= 2^-7 relative) plus `atol` (the two blends may
    round to different bf16 neighbours; near 0 the float32 difference
    itself shows), and at most 1% of the entries differing."""
    d = (got.float() - want.float()).abs()
    return bool((d <= 2.0 ** -7 * want.float().abs() + atol).all()
                and float((d > 0).float().mean()) <= 0.01)


def phase_step(kernel, plain, xdim, ydim, hexa, gaussian, B, D, radius, seed,
               name="som_fused_train_step", kw=None, bf16=False, dup=False,
               codes_tol=1e-4, val_tol=(1e-4, 1e-3), win_rel=1e-5, twin=None,
               tf32x3=False, separable=False, route_mult=None, plain_memo=None):
    """A fused-step kernel (K3, K13 or K14, options `kw`) against its plain
    version: a few samples without a BMU, per-sample alphas.  Codes within
    `codes_tol` (a bf16 codebook: bf16_ulp_close), winners equal except where
    the two rows' distances differ by less than `win_rel` (under batch_bf16
    the distances the kernel ranks by), values within `val_tol` (rtol,
    atol).  On a float32 codebook the winner half is also held against the
    plain scoring (fused_step_winners) on the kernel's own updated rows,
    where the two codebooks' rounding differences cannot enter: winners to
    `win_rel`, values to `val_tol`, or to (1e-4, 1e-4) under batch_bf16.
    With `dup` every code is there three times and alpha is 0: the rows do
    not move, and the first copy must win every exact tie, as in the plain
    version.  With `twin` (options), the kernel run under those options on
    the same inputs must give the same codebook, winners and values bit for
    bit (K14's stagger against its main form; K3, K13 and K14's main form
    against a rerun).  `tf32x3` (K3, K13) adds the split-TF32 route's bound and share, and on a float32 codebook
    the mean distance of the kernel's and the plain version's codebooks from
    the same blend taken in float64 (W from the separable factors with
    `separable`, K13's); `route_mult` (K14's main form) the route's bound and
    share alone, at that many TF32 products per float32 product.  With
    `plain_memo` (a dict) the plain run's outputs and time are taken from
    it where an earlier call on the same case and options left them, else
    left there: the plain version is deterministic, so a case run at
    several launch settings (K14's cluster sizes) runs and times it once."""
    import torch

    from som_lvq_pak_torch.ops.dist_argmin import dist_argmin_plain
    from som_lvq_pak_torch.ops.som_step import fused_step_winners

    kw = kw or {}
    noc = xdim * ydim
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dup:
        base = torch.randn((noc // 3, D), generator=g, device="cuda")
        codes = torch.cat([base, base, base]).contiguous()
    else:
        codes = torch.randn((noc, D), generator=g, device="cuda")
    xb = torch.randn((B, D), generator=g, device="cuda")
    xn = torch.randn((B, D), generator=g, device="cuda")
    bmu = dist_argmin_plain(xb, codes)[1]
    bmu[:7] = -1  # samples without a BMU teach nothing
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device="cuda")
    if dup:
        alpha.zero_()
    if bf16:
        codes = codes.to(torch.bfloat16)
    ck, ik, vk = kernel(codes.clone(), xb, bmu, xn, xdim, hexa, alpha, radius, gaussian, **kw)
    memo = {} if plain_memo is None else plain_memo
    if "out" not in memo:
        memo["out"] = plain(codes.clone(), xb, bmu, xn, xdim, hexa, alpha, radius, gaussian,
                            **kw)
    cp, ip, vp = memo["out"]
    torch.cuda.synchronize()
    name = f"{name} {xdim}x{ydim} {'hexa' if hexa else 'rect'} " \
           f"{'gaussian' if gaussian else 'bubble'}" \
           + "".join(f" {k}={v}" for k, v in kw.items()) \
           + (" bf16 codebook" if bf16 else "") + (" every code three times" if dup else "")
    if twin is not None:
        tw = kernel(codes.clone(), xb, bmu, xn, xdim, hexa, alpha, radius, gaussian, **twin)
        if not all(torch.equal(a, b) for a, b in zip((ck, ik, vk), tw)):
            raise AssertionError(f"{name}: not bit-equal to {kernel.__name__} under {twin}")
    err = float((ck.float() - cp.float()).abs().max())
    if not (bf16_ulp_close(ck, cp) if bf16
            else torch.allclose(ck, cp, rtol=codes_tol, atol=codes_tol)):
        raise AssertionError(f"{name}: codebooks differ by {err}")
    batch_bf16 = bool(kw.get("batch_bf16"))
    n_diff = check_winners(name, xn, ck.float(), ik, ip, rel=win_rel, bf16_score=batch_bf16,
                           codes_plain=cp.float())
    val_err = float((vk - vp).abs().max())
    if not torch.allclose(vk, vp, rtol=val_tol[0], atol=val_tol[1]):
        raise AssertionError(f"{name}: winner values differ by {val_err}")
    own_val_err = None
    if not bf16:  # a bf16 codebook keeps no float32 rows to score
        i_own, v_own = fused_step_winners(ck, xn, batch_bf16)
        check_winners(f"{name} on its own rows", xn, ck, ik, i_own, rel=win_rel,
                      bf16_score=batch_bf16)
        own_val_err = float((vk - v_own).abs().max())
        own_tol = (1e-4, 1e-4) if batch_bf16 else val_tol
        if not torch.allclose(vk, v_own, rtol=own_tol[0], atol=own_tol[1]):
            raise AssertionError(f"{name}: winner values differ from the plain scoring "
                                 f"of its own rows by {own_val_err}")
    if dup and not (torch.equal(ck, codes) and torch.equal(ik, ip)
                    and int(ik.max()) < noc // 3):
        raise AssertionError(f"{name}: rows moved at alpha 0, or an exact tie went "
                             "unlike the plain version or to a later copy")
    f64 = {}
    if tf32x3 and not bf16:  # the codebook and the plain one against float64
        from som_lvq_pak_torch.ops import som_step as ss

        aw, r = ss._alpha_r(alpha, radius, B, "cuda")
        if separable:
            w = ss.separable_w(bmu, aw.double(), r.double(), noc, xdim, hexa,
                               gaussian).double()
        else:
            units = torch.arange(noc, dtype=torch.int32, device="cuda")
            w = ss.neighborhood_w(bmu, aw, r, units, xdim, hexa, gaussian).double()
        exact = ss.guarded_blend(codes.double(), w @ xb.double(), w.sum(1, keepdim=True))
        f64 = dict(mean_abs_err_vs_f64=float((ck.double() - exact).abs().mean()),
                   plain_mean_abs_err_vs_f64=float((cp.double() - exact).abs().mean()))
        del w, exact
    work = codes.clone()
    # update W.X and winners, 2 noc B D FLOPs each (bf16 x bf16 products
    # under batch_bf16, a BF16 MMA's); codes read and written, both batches,
    # bmu and alpha read, the next winners written
    cb = codes.element_size()
    mult = 3 if tf32x3 else route_mult
    rec = dict(kernel=name, shape=[noc, B, D], radius=radius, winners_differ=n_diff,
               max_abs_err=err, val_err=val_err, own_val_err=own_val_err, **f64,
               **({} if twin is None else dict(bit_equal_to=twin)),
               ms=cuda_ms(lambda: kernel(work, xb, bmu, xn, xdim, hexa, alpha, radius,
                                         gaussian, **kw)),
               plain_ms=memo["ms"] if "ms" in memo else memo.setdefault("ms", cuda_ms(
                   lambda: plain(work, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian,
                                 **kw))),
               **bound(4 * noc * B * D, 2 * cb * noc * D + 8 * B * D + 16 * B,
                       PEAK_BF16_FLOPS if batch_bf16 else PEAK_FP32_FLOPS,
                       route_flops=mult * 4 * noc * B * D if mult else None))
    if mult:
        rec.update(route_pct(rec))
    # library_ms stays null: no one PyTorch call computes the step (its
    # plain version's chain is plain_ms)
    emit("kernels", **rec)
    return rec


# the feature passes' widths: past PASS_D (256) the SOM step kernels run in
# passes of 256 features; D 300 is one full slab and a ragged one, D 512 two
# full ones, D 1024 four
WIDE_DS = (300, 512)


def wide_d_phases(recs):
    """The SOM step kernels past 256 features (their feature passes) against
    their plain versions under the gates each has at D <= 256, at small maps:
    K3 (factored=False), K13 and K14's main form (its bf16 batches too) at
    D 300 and 512, each rerun bit-equal, with a bf16 codebook (its float32
    rows copy, rows32) at 300; K14's stagger bit-equal to its main form and
    its int8_win held as at D 64, at 300; K5 and K6 (K5 bit-equal to K3),
    K7 (bit-equal to K chained K3 steps), K11 then K12 (their shard step
    bit-equal to K3's, and each against its plain version) and K17 at 300
    and 512; K3 and K6 (sixteen 64-feature slabs on gridDim.y) at 1024.
    Then the wide e2e path's own shapes (phase 4w): K1 at its
    step (1024 x 16384 x 512, rerun, bit-equal to K2), K2 at its
    evaluation (100,000 x 16384 x 512, rerun) and K13 at its step (128x128
    hexa gaussian, B 1024, D 512, radius 32, rerun).  Last, K7's shared
    memory by the C layout's count: up to D 128 the walk's CTA at every
    cluster size (its Python mirror's count), past it 16-row CTAs of whole
    rows at B 256, within the card's opt-in at every D 1-1024.  Each kernel's largest error
    joins its record's max_abs_err."""
    import torch

    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.ops.dist_argmin import (dist_argmin, dist_argmin_plain,
                                                   dist_argmin_t, dist_argmin_t_plain)
    from som_lvq_pak_torch.ops.som_step import (feature_passes, som_fused_factored_step,
                                                som_fused_factored_step_plain,
                                                som_fused_train_step,
                                                som_fused_train_step_plain)
    from som_lvq_pak_torch.ops.som_update import (som_neighborhood_update_idx,
                                                  som_neighborhood_update_idx_masked,
                                                  som_neighborhood_update_idx_plain)

    def worst(name, rs):
        recs[name]["max_abs_err"] = max([recs[name]["max_abs_err"]]
                                        + [r["max_abs_err"] for r in rs])

    k3 = lambda *a, **kw: som_fused_train_step(*a, factored=False, **kw)  # noqa: E731
    rs3, rs13, rs14 = [], [], []
    f32_tols = dict(codes_tol=1e-5, val_tol=(1e-4, 1e-4), twin={}, tf32x3=True,
                    separable=True)
    for j, D in enumerate(WIDE_DS + (1024,)):
        rs3.append(phase_step(k3, som_fused_train_step_plain, 16, 16, True, True, 256, D,
                              4.0, seed=100 + j, twin={}, tf32x3=True))
        if D == 1024:
            break
        rs13.append(phase_step(som_fused_factored_step, som_fused_factored_step_plain, 32,
                               32, True, True, 512, D, 8.0, seed=110 + j,
                               name="som_fused_factored_step", **f32_tols))
        for kw, seed in ((dict(batch_chunk=1024), 120 + j), (K14_BOTH, 130 + j)):
            rs14.append(k14_step((32, 32, True, True, 1024, D, 8.0), seed, kw))
    # a bf16 codebook: the blend writes its float32 rows beside it for the
    # winners' slabs
    phase_step(k3, som_fused_train_step_plain, 16, 16, True, True, 256, 300, 4.0,
               seed=140, bf16=True, win_rel=1e-2, twin={}, tf32x3=True)
    phase_step(som_fused_factored_step, som_fused_factored_step_plain, 32, 32, True, True,
               512, 300, 8.0, seed=141, name="som_fused_factored_step", bf16=True,
               val_tol=(1e-4, 1e-4), win_rel=1e-2, twin={}, tf32x3=True)
    k14_step((32, 32, True, True, 1024, 300, 8.0), 142, K14_BOTH, bf16=True)
    # K14's options past 256: stagger bit-equal to the main form, int8_win
    worst("som_fused_factored_chunked_step[stagger]",
          [k14_step((32, 32, True, True, 1024, 300, 8.0), 143,
                    dict(K14_BOTH, stagger=True), twin=K14_BOTH)])
    worst("som_fused_factored_chunked_step[int8_win]",
          [phase_int8(32, 32, True, True, 1024, 300, 8.0, seed=144, kw=K14_BOTH)])
    worst("som_fused_train_step", rs3)
    worst("som_fused_factored_step", rs13)
    worst("som_fused_factored_chunked_step", rs14)
    # K5 (bit-equal to K3) and K6 at 300 and 512, K6 also at 1024
    for k, p in ((som_neighborhood_update_idx, som_neighborhood_update_idx_plain),
                 (som_neighborhood_update_idx_masked,
                  lambda c, x, b, m, *a: som_neighborhood_update_idx_plain(
                      c, x, b, *a, mask=m))):
        masked = k is som_neighborhood_update_idx_masked
        worst(k.__name__, [phase_update(k, p, 16, 16, True, True, 256, D, 4.0,
                                        seed=150 + D, masked=masked)
                           for D in WIDE_DS + ((1024,) if masked else ())])
    # K7: its group bit-equal to K chained K3 steps (the grouped trainer's
    # choice at 32x32, D 300)
    worst("som_vmem_train_steps",
          [phase_vmem(32, 32, True, True, D, 256, 8, 8.0, 0.01, seed=160 + j, varied=True)
           for j, D in enumerate(WIDE_DS)])
    # K11 and K12 against their plain versions, then on a shard: K11 + K12
    # bit-equal to K3
    worst("som_neighborhood_accumulate",
          [phase_accum(32, True, True, 512, 512, 512, D, 8.0, True, seed=170 + j)
           for j, D in enumerate(WIDE_DS)])
    worst("som_blend_winner", [phase_blend(1024, D, 512, seed=180 + j)
                               for j, D in enumerate(WIDE_DS)])
    for j, D in enumerate(WIDE_DS):
        phase_shard_step(32, True, True, 512, D, 8.0, seed=190 + j)
    # K17, float32 and bf16
    worst("fused_step_skeleton",
          [phase_skeleton(512, bf16, seed=200 + j, N=2048, D=D, T=256, Bn=300, iters=3)
           for j, D in enumerate(WIDE_DS) for bf16 in (False, True)])
    # the wide e2e path's shapes: K1 at its step, K2 at its evaluation, K13
    # at its step
    worst("dist_argmin", [phase_distance("dist_argmin", dist_argmin, dist_argmin_plain,
                                         1024, 16384, 512, seed=210, rerun=True,
                                         twin=dist_argmin_t)])
    worst("dist_argmin_t", [phase_distance("dist_argmin_t", dist_argmin_t,
                                           dist_argmin_t_plain, 100_000, 16384, 512,
                                           seed=211, iters=3, rerun=True)])
    worst("som_fused_factored_step",
          [phase_step(som_fused_factored_step, som_fused_factored_step_plain, 128, 128,
                      True, True, 1024, 512, 32.0, seed=212,
                      name="som_fused_factored_step", **f32_tols)])
    # K7's shared memory, the C layout's count: up to D 128 the walk's CTA
    # (its tile's 128 rows split, the ring) at every cluster size, equal to
    # its Python mirror; past it whole rows (every pass's slab) of a 16-row
    # CTA at B 256; within the opt-in at every D
    from som_lvq_pak_torch.ops import som_vmem

    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    smem = _build.library().somvq_vmem_smem_bytes
    for D in range(1, 1025):
        n, dp = feature_passes(D)
        if som_vmem.k7_route(D) == "sm90":
            for c in som_vmem.k7_clusters(D):
                got = smem(128, c, 256, D)
                low = 2 * 4 * 128 * som_vmem.sm90_width(D)
                if not (low <= got <= optin and got == som_vmem.k7_walk_smem_bytes(D, c)):
                    raise AssertionError(f"K7's walk at D {D}, cluster {c}: {got} bytes of "
                                         f"shared memory, not within [{low}, {optin}] or not "
                                         f"{som_vmem.k7_walk_smem_bytes(D, c)}")
            continue
        got = smem(16, 1, 256, D)
        if not 4 * 16 * n * dp <= got <= optin:
            raise AssertionError(f"K7 at D {D}: {got} bytes of shared memory for 16 "
                                 f"rows, not within [{4 * 16 * n * dp}, {optin}]")


def phase_segment_sum(B, C, noc, seed, kind="spread", iters=10):
    """The LVQ steps' fixed-order segment sum (csrc/segment_sum.cu) on the
    card: bit-equal to np.add.at on the host copy (each segment's rows in
    sample order from 0.0) and to a rerun, rows of mixed scale with some -0;
    `kind` "spread" draws ids over every segment, "hot" puts 90% of the rows
    in one.  Timed against index_add_, which on CUDA sums with atomics in no
    fixed order (its plain version there, and the one PyTorch call of the
    same function).  Its bound: the rows and ids read once, the (noc, C)
    output written once."""
    import torch

    from som_lvq_pak_torch.ops.segment_sum import segment_sum, segment_sum_plain

    rng = np.random.default_rng(seed)
    shape = (B,) if C is None else (B, C)
    rows = (rng.normal(size=shape) * np.exp2(rng.integers(-20, 20, size=shape)))
    rows = rows.astype(np.float32)
    rows[rng.random(shape) < 0.05] = -0.0
    seg = rng.integers(0, noc, size=B)
    if kind == "hot":
        seg = np.where(rng.random(B) < 0.9, noc // 3, seg)
    want = np.zeros((noc,) + shape[1:], np.float32)
    np.add.at(want, seg, rows)
    rows_d = torch.from_numpy(rows).to("cuda")
    seg_d = torch.from_numpy(seg).to("cuda")
    got = segment_sum(rows_d, seg_d, noc)
    again = segment_sum(rows_d, seg_d, noc)
    torch.cuda.synchronize()
    name = f"segment_sum {kind} {B}x{C or 1} into {noc}"
    if not np.array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32)):
        raise AssertionError(f"{name}: not bit-equal to np.add.at")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    # against the plain version's result on the host copy (np.add.at, the
    # CPU's index_add_ order); CUDA's index_add_ sums in another order
    plain = segment_sum_plain(rows_d, seg_d, noc)
    width = 1 if C is None else C
    rec = dict(kernel=name, shape=[B, width, noc], bit_equal_to="np.add.at",
               bit_equal_rerun=True,
               max_abs_err=float(np.abs(got.cpu().numpy() - want).max()),
               cuda_index_add_max_abs_err=float((got - plain).abs().max()),
               ms=cuda_ms(lambda: segment_sum(rows_d, seg_d, noc), iters),
               plain_ms=cuda_ms(lambda: segment_sum_plain(rows_d, seg_d, noc), iters),
               **bound(B * width, 4 * B * width + 8 * B + 4 * noc * width))
    rec["library_ms"] = rec["plain_ms"]  # index_add_ into zeros
    emit("kernels", **rec)
    return rec


def lvq_resume_check(X, lab, codes, steps=40, every=16):
    """OLVQ1Trainer on the card, interrupted at a checkpoint and resumed,
    against the run without the interruption: the codebook and the alphas
    bit-equal (the Dataset sampler draws batch b from (seed, b), and every
    step's sums run in a fixed order).  Checkpoints every `every` batches
    into a temporary directory; the resumed run starts from the second."""
    import tempfile

    from som_lvq_pak_torch.models.som import Dataset
    from som_lvq_pak_torch.models.trainer import OLVQ1Trainer

    data = Dataset(points=X, labels=lab)
    rlen = steps * 1024
    with tempfile.TemporaryDirectory() as d:
        kw = dict(batch_size=1024, alpha=0.3, seed=4, checkpoint_dir=d, device="cuda")
        full_t = OLVQ1Trainer(codes, checkpoint_interval=every, **kw)
        full_t.ckpt.keep = 0
        full = full_t.fit(data, rlen=rlen)
        full_alphas = full_t.ckpt.load(steps).alphas
        tr = OLVQ1Trainer(codes, **kw)
        kept = [st for st in tr.ckpt.steps() if st <= 2 * every]
        for st in tr.ckpt.steps():
            if st > 2 * every:
                os.remove(os.path.join(d, f"step_{st}.npz"))
        resumed = tr.fit(data, rlen=rlen)
        alphas = tr.ckpt.load().alphas
    if not (np.array_equal(resumed.points.view(np.int32), full.points.view(np.int32))
            and np.array_equal(np.asarray(alphas).view(np.int32),
                               np.asarray(full_alphas).view(np.int32))):
        raise AssertionError("olvq1 resumed on the card is not bit-equal to the run "
                             "without the interruption")
    return dict(steps=steps, resumed_from=max(kept), bit_equal=True)


def phase_bubble_boundary():
    """The exact bubble boundary through K13 and K14 on the card: on an 8x6
    hexa map a sample with BMU (column 2, row 0) and r = 3 reaches the unit
    (column 3, row 3) at dx = 1.5, dy^2 = 9 * 0.75, so d2 = r^2 exactly and
    the unit is inside.  K13 takes one sample of alpha 0.5; K14 128 such
    samples of alpha 2^-8 (wsum exactly 0.5, B a multiple of its chunk).
    The unit must become 0.5 exactly, and each codebook equal its plain
    version's and a rerun's bit for bit."""
    import torch

    from som_lvq_pak_torch.ops import som_step as ss

    xdim, D, inside = 8, 64, 3 * 8 + 3
    for name, fn, plain, B, a, kw in (
            ("K13", ss.som_fused_factored_step, ss.som_fused_factored_step_plain,
             1, 0.5, {}),
            ("K14", ss.som_fused_factored_chunked_step,
             ss.som_fused_factored_chunked_step_plain, 128, 2.0 ** -8,
             dict(batch_chunk=128, batch_bf16=True))):
        codes = torch.zeros((48, D), device="cuda")
        xb = torch.ones((B, D), device="cuda")
        bmu = torch.full((B,), 2, dtype=torch.int32, device="cuda")
        ck = fn(codes.clone(), xb, bmu, xb, xdim, True, a, 3.0, False, **kw)[0]
        again = fn(codes.clone(), xb, bmu, xb, xdim, True, a, 3.0, False, **kw)[0]
        cp = plain(codes.clone(), xb, bmu, xb, xdim, True, a, 3.0, False, **kw)[0]
        torch.cuda.synchronize()
        if not (torch.equal(ck, cp) and torch.equal(ck, again)
                and bool((ck[inside] == 0.5).all())):
            raise AssertionError(f"{name}: the exact bubble boundary went wrong: "
                                 f"{ck[inside, :4].tolist()}")
    emit("kernels", kernel="exact bubble boundary, K13 and K14", inside_equals_half=True,
         equal_plain=True, rerun_bit_equal=True)


def phase_int8(xdim, ydim, hexa, gaussian, B, D, radius, seed, kw, bf16=False):
    """K14 with int8_win (options `kw`) on phase_step's inputs.  The codebook
    must equal, bit for bit, that of K14's main form (without int8_win: the
    update half int8_win's walk runs), and K14's with stagger added (winners
    and values too).  A bf16 codebook's int8 rows and
    ||m||^2 come from the float32 blend, not the rows rounded for storage:
    its winners and values must equal, bit for bit, those of the same step
    on the codebook widened to float32, and its rows that step's rounded to
    bf16, on the kernel and on the plain version alike; the checks below then
    hold those float32 steps.  Winners must equal the plain int8 scoring of
    the kernel's own float32 rows (fused_step_winners_int8, with
    int8_win_inputs' scales) except where the two rows' scores differ by
    less than 1e-6 relative (||m||^2's float32 sum order), values within
    1e-5 relative of it.  Against the plain int8 run (codes within 1e-5):
    winners equal except where the plain run's two scores lie within
    q1 * sum_k |x'_k| of each other (one quantization step in every entry
    of the row), and where the winners agree, values within 5e-5 + 1e-5
    relative (the largest difference on an H100 at these cases was 1.5e-5).
    Its route's bound: the update's TF32 products (three per FP32 product,
    one under batch_bf16) at 495 TFLOP/s plus the winners' 2 noc B D int8
    operations at 1979 TOP/s."""
    import torch

    from som_lvq_pak_torch.ops.dist_argmin import dist_argmin_plain
    from som_lvq_pak_torch.ops.som_step import (
        fused_step_winners_int8, int8_win_inputs, int8_win_scores,
        som_fused_factored_chunked_step as k14,
        som_fused_factored_chunked_step_plain as k14p)

    noc = xdim * ydim
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randn((noc, D), generator=g, device="cuda")
    xb = torch.randn((B, D), generator=g, device="cuda")
    xn = torch.randn((B, D), generator=g, device="cuda")
    bmu = dist_argmin_plain(xb, codes)[1]
    bmu[:7] = -1
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device="cuda")
    if bf16:
        codes = codes.to(torch.bfloat16)
    args = (xb, bmu, xn, xdim, hexa, alpha, radius, gaussian)
    with k14_cluster_forced(1):  # the main form's sums in the walk's own order
        c0 = k14(codes.clone(), *args, **kw)[0]
    ck, ik, vk = k14(codes.clone(), *args, int8_win=True, **kw)
    cs, is_, vs = k14(codes.clone(), *args, int8_win=True, stagger=True, **kw)
    cp, ip, vp = k14p(codes.clone(), *args, int8_win=True, **kw)
    torch.cuda.synchronize()
    name = (f"som_fused_factored_chunked_step {xdim}x{ydim} {'hexa' if hexa else 'rect'} "
            f"{'gaussian' if gaussian else 'bubble'} int8_win=True"
            + "".join(f" {k}={v}" for k, v in kw.items()) + (" bf16 codebook" if bf16 else ""))
    if not torch.equal(ck, c0):
        raise AssertionError(f"{name}: the codebook differs from K14's main form "
                             "without int8_win")
    if not (torch.equal(cs, ck) and torch.equal(is_, ik) and torch.equal(vs, vk)):
        raise AssertionError(f"{name}: stagger=True is not bit-equal")
    if bf16:
        for side, fn, got in (("kernel", k14, (ck, ik, vk)), ("plain", k14p, (cp, ip, vp))):
            c32, i32, v32 = fn(codes.float(), *args, int8_win=True, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], c32.to(torch.bfloat16)) and torch.equal(got[1], i32)
                    and torch.equal(got[2], v32)):
                raise AssertionError(f"{name}: the {side}'s step differs from its step on "
                                     "the float32 codebook (rows rounded to bf16)")
            if side == "kernel":
                ck, ik, vk = c32, i32, v32
            else:
                cp, ip, vp = c32, i32, v32
    err = float((ck - cp).abs().max())
    if not torch.allclose(ck, cp, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name}: codebooks differ from plain by {err}")
    xq, q = int8_win_inputs(codes, xb, xn, bool(kw.get("batch_bf16")))
    i_own, v_own = fused_step_winners_int8(ck, xq, q, 1024)
    bad = (ik != i_own).nonzero()[:, 0]
    own_diff = int(bad.numel())
    if own_diff:
        sa = int8_win_scores(ck, ik[bad], xq[bad], q)
        sb = int8_win_scores(ck, i_own[bad], xq[bad], q)
        gap = float(((sa - sb).abs() / torch.maximum(sa.abs(), sb.abs())).max())
        if gap >= 1e-6:
            raise AssertionError(f"{name}: {own_diff} winners differ from the int8 "
                                 f"scoring of its own rows, relative gap {gap:.3g}")
    own_val_err = float(((vk - v_own).abs() / v_own.abs().clamp(min=1e-30)).max())
    if not bool(((vk - v_own).abs() <= 1e-5 * v_own.abs() + 1e-6).all()):
        raise AssertionError(f"{name}: values differ from the int8 scoring of its "
                             f"own rows by {own_val_err:.3g} relative")
    bad = (ik != ip).nonzero()[:, 0]
    if bad.numel():
        sk = int8_win_scores(cp, ik[bad], xq[bad], q)
        sp = int8_win_scores(cp, ip[bad], xq[bad], q)
        window = q[1].double() * xq[bad].double().abs().sum(-1)
        if bool((sp - sk > window).any()):
            raise AssertionError(f"{name}: {bad.numel()} winners differ from the plain "
                                 "int8 run beyond one quantization step")
    same = ik == ip
    val_err = float((vk - vp)[same].abs().max()) if bool(same.any()) else 0.0
    if not bool(((vk - vp)[same].abs() <= 5e-5 + 1e-5 * vp[same].abs()).all()):
        raise AssertionError(f"{name}: values differ from the plain int8 run by {val_err} "
                             "where the winners agree")
    work = codes.clone()
    batch_bf16 = bool(kw.get("batch_bf16"))
    cb = codes.element_size()
    # the update's W.X at the FP32 peak (BF16 under batch_bf16), the
    # winners' int8 contraction at the INT8 peak; codes read and written,
    # both batches (x' as int8), bmu and alpha read, the winners written
    rec = dict(kernel=name, shape=[noc, B, D], radius=radius,
               winners_differ=int(bad.numel()), own_winners_differ=own_diff,
               max_abs_err=err, own_val_rel_err=own_val_err, val_err=val_err,
               ms=cuda_ms(lambda: k14(work, *args, int8_win=True, **kw)),
               plain_ms=cuda_ms(lambda: k14p(work, *args, int8_win=True, **kw)),
               **bound(2 * noc * B * D, 2 * cb * noc * D + 5 * B * D + 16 * B,
                       PEAK_BF16_FLOPS if batch_bf16 else PEAK_FP32_FLOPS,
                       int8_ops=2 * noc * B * D,
                       route_flops=(1 if batch_bf16 else 3) * 2 * noc * B * D))
    rec.update(route_pct(rec))
    emit("kernels", **rec)
    return rec


def phase_probe(name, kernel, plain, library, dtype, N, D, B, seed, dup=False, iters=10,
                normal=False, kind="random", label=None):
    """K15 (int8) or K16 (float32, on integer values) against its plain
    version, bit for bit, and against a rerun on the same inputs; with `dup`
    every row is there twice.  `kind` "negative": m in [1, 127] and x in
    [-127, -1], every maximum negative; "min": m and x in [-128, 127] with
    every 7th row of m and every 5th column of x at -128.  With `normal`
    (K16) m and x are normal floats instead, held within PROBE_F32_REL of
    the float64 plain version.  library_ms: one PyTorch call of the same
    function (`library`), where given.  K16 also carries its split-TF32
    route's bound (three TF32 products per float32 product) and share; K15
    its route (int8 wgmma) and the share of its bound."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if normal:
        m = torch.randn((N, D), generator=g, device="cuda")
        x = torch.randn((D, B), generator=g, device="cuda")
    else:
        (m_lo, m_hi), (x_lo, x_hi) = {"random": ((-127, 128), (-127, 128)),
                                      "negative": ((1, 128), (-127, 0)),
                                      "min": ((-128, 128), (-128, 128))}[kind]
        m = torch.randint(m_lo, m_hi, (N // 2 if dup else N, D), generator=g, device="cuda",
                          dtype=torch.int8)
        if dup:
            m = torch.cat([m, m]).contiguous()
        x = torch.randint(x_lo, x_hi, (D, B), generator=g, device="cuda", dtype=torch.int8)
        if kind == "min":
            m[::7] = -128
            x[:, ::5] = -128
        m, x = m.to(dtype), x.to(dtype)
    got, want = kernel(m, x), plain(m, x)
    again = kernel(m, x)
    torch.cuda.synchronize()
    label = label or (f"{name} {N}x{D}x{B}" + (" normal" if normal else "") +
                      ("" if kind == "random" else f" {kind}"))
    err = float((got.double() - want.double()).abs().max())
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two runs on the same inputs differ")
    if normal:
        rel = float(((got.double() - want.double()).abs() / want.double().abs()).max())
        if not rel <= PROBE_F32_REL:
            raise AssertionError(f"{label}: {rel} relative from float64, over "
                                 f"{PROBE_F32_REL}")
    elif not torch.equal(got, want):
        raise AssertionError(f"{label}: differs from plain by {err}")
    es = m.element_size()
    # 2 N D B multiply-adds at the operand type's peak; m and x read once,
    # the (B,) maxima written
    split_tf32 = dtype == torch.float32
    rec = dict(kernel=name, shape=[N, D, B], dup=dup, normal=normal, max_abs_err=err,
               bit_equal_rerun=True,
               **({"max_rel_err": rel} if normal else {}),
               ms=cuda_ms(lambda: kernel(m, x), iters),
               plain_ms=cuda_ms(lambda: plain(m, x), iters),
               **bound(2 * N * D * B, es * (N * D + D * B) + 4 * B,
                       PEAK_FP32_FLOPS if split_tf32 else PEAK_INT8_OPS,
                       route_flops=3 * 2 * N * D * B if split_tf32 else None))
    if split_tf32:
        rec.update(route_pct(rec))
    else:
        rec.update(route="wgmma", kind=kind, label=label,
                   bound_pct=100.0 * rec["bound_ms"] / rec["ms"])
    if library is not None:
        rec["library_ms"] = cuda_ms(lambda: library(m, x), iters)
    emit("kernels", **rec)
    return rec


def phase_skeleton(B, bf16, seed, N=65536, D=64, T=256, iters=10, Bn=None):
    """K17 against its plain version at bench.py:prep_skeleton's shapes (W
    uniform * 0.001, X normal, X' = X; with `Bn`, X' is Bn normal samples of
    its own): at scale 1.0 out within 1e-4, and
    vmax within 1e-4 relative of the plain scoring of the kernel's own out
    (and, in float32, of the plain run's: two outs equal to 1e-6 may round to
    neighbouring bf16 values), and a rerun bit-equal; timed at the default
    scale 1e-30.  Its route's bound: the 4 N B D FLOPs the kernel issues
    (W.X for every tile, as bench.py's kernel), three TF32 products each for
    float32 operands, one for bf16 (exact in TF32); library_ms: the PyTorch
    chain of the same function under fp32_matmul(), W.X once by one mm, the
    gather-add, one mm and amax (the plain version's chain: at these shapes
    its row blocks are one block).  At the bench shapes also update_ms and
    winners_ms: the kernel with x' or W and X cut to 64 samples, each of its
    two contractions nearly alone."""
    import torch

    from som_lvq_pak_torch.ops.skeleton import (fused_step_skeleton,
                                                fused_step_skeleton_plain)

    def chain(codes, w, x, xn, scale=1e-30):
        acc = w.to(torch.float32) @ x.to(torch.float32)
        out = codes + acc[torch.arange(codes.shape[0], device="cuda") % w.shape[0]] * scale
        return out, (out.to(xn.dtype).to(torch.float32) @ xn.to(torch.float32).T).amax(0)

    dt = torch.bfloat16 if bf16 else torch.float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randn((N, D), generator=g, device="cuda")
    w = (torch.rand((T, B), generator=g, device="cuda") * 0.001).to(dt)
    x = torch.randn((B, D), generator=g, device="cuda").to(dt)
    xn = x if Bn is None else torch.randn((Bn, D), generator=g, device="cuda").to(dt)
    name = f"fused_step_skeleton {N}x{D} B {B} {'bf16' if bf16 else 'float32'}" + (
        "" if Bn is None else f" T {T} B' {Bn}")
    errs = []
    for scale in (1.0, 1e-30):
        ok, vk = fused_step_skeleton(codes, w, x, xn, scale)
        o2, v2 = fused_step_skeleton(codes, w, x, xn, scale)
        op, vp = fused_step_skeleton_plain(codes, w, x, xn, scale)
        v_own = fused_step_skeleton_plain(ok, w, x, xn, 0.0)[1]  # out = ok exactly
        torch.cuda.synchronize()
        if not (torch.equal(ok, o2) and torch.equal(vk, v2)):
            raise AssertionError(f"{name} scale {scale}: two runs on the same inputs differ")
        errs.append(float((ok - op).abs().max()))
        want = (v_own,) if bf16 else (v_own, vp)
        if not (torch.allclose(ok, op, rtol=1e-4, atol=1e-4)
                and all(bool(((vk - v).abs() <= 1e-4 * v.abs()).all()) for v in want)):
            raise AssertionError(f"{name} scale {scale}: out differs by {errs[-1]}, vmax "
                                 f"by {float((vk - v_own).abs().max())} from its own "
                                 f"rows' scoring, {float((vk - vp).abs().max())} from plain")
    es = w.element_size()
    # the function's own operations at the operand type's peak: W.X once
    # (2 T B D; the kernel, like bench.py's, redoes it for each of the N / T
    # tiles) and out.x' (2 N B D); codes read and out written, W, X and X'
    # read once, vmax written
    Bn = xn.shape[0]
    rec = dict(kernel=name, shape=[N, B, D], max_abs_err=max(errs), bit_equal_rerun=True,
               ms=cuda_ms(lambda: fused_step_skeleton(codes, w, x, xn), iters),
               plain_ms=cuda_ms(lambda: fused_step_skeleton_plain(codes, w, x, xn), iters),
               **bound(2 * T * B * D + 2 * N * Bn * D,
                       8 * N * D + es * (T * B + B * D + Bn * D) + 4 * Bn,
                       PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS,
                       route_flops=(1 if bf16 else 3) * 2 * N * (B + Bn) * D))
    rec.update(route_pct(rec))
    rec["library_ms"] = cuda_ms(lambda: chain(codes, w, x, xn), iters)
    if xn is x:  # where the time goes: each contraction with the other cut to 64
        w64, x64 = w[:, :64].contiguous(), x[:64].contiguous()
        rec.update(update_ms=cuda_ms(lambda: fused_step_skeleton(codes, w, x, xn[:64]),
                                     iters),
                   winners_ms=cuda_ms(lambda: fused_step_skeleton(codes, w64, x64, xn),
                                      iters))
    emit("kernels", **rec)
    return rec


# K14's cases in phase 3: e2e_64x64_1M_B4096's step (the JAX trainer's
# choice there: chunk 1024, bf16 x-pattern and batches) first, then
# bench.py:849-858's headline shapes (256x256, chunk 1024: B 4096 with the
# bf16 x-pattern, B 8192 with both), bubble (its x-pattern stays float32)
# with and without bf16 batches, and a bf16 codebook.  Under batch_bf16 the
# winners score bf16-rounded rows: where the kernel's and the plain
# version's float32 rows (equal to 1e-5) round to bf16 neighbours, a value
# moves by the sample's component times one bf16 ulp of the entry (at most
# 0.0012 on an H100 at these shapes), so values within 5e-3 of the plain
# run's; against the plain scoring of the kernel's own rows within 1e-4
K14_BOTH = dict(batch_chunk=1024, wxa_bf16=True, batch_bf16=True)
K14_CASES = (((64, 64, True, True, 4096, 64, 16.0), 47, K14_BOTH),
             ((256, 256, True, True, 4096, 64, 64.0), 48,
              dict(batch_chunk=1024, wxa_bf16=True)),
             ((256, 256, True, True, 8192, 64, 64.0), 49, K14_BOTH),
             ((64, 64, True, False, 4096, 64, 16.0), 50, dict(batch_chunk=1024)),
             ((64, 64, True, False, 4096, 64, 16.0), 51,
              dict(batch_chunk=1024, batch_bf16=True)))
K14_BF16_CODEBOOK = ((64, 64, True, True, 4096, 64, 16.0), 52)
# the trainer's other K14 maps at B 4096 (models.trainer.fused_step_choice:
# 32x32 and 64x32 hexa gaussian, both bf16 options) and 128x128, timed at
# every cluster size beside 64x64's
K14_CLUSTER_CASES = (((32, 32, True, True, 4096, 64, 8.0), 58, K14_BOTH),
                     ((64, 32, True, True, 4096, 64, 16.0), 59, K14_BOTH),
                     ((128, 128, True, True, 4096, 64, 32.0), 60, K14_BOTH))


def k14_step(case, seed, kw, twin=None, bf16=False, name="som_fused_factored_chunked_step",
             plain_memo=None):
    """phase_step on K14 with options `kw`, at the tolerances of its batches
    and codebook, with its route's bound (one TF32 product per float32
    product under batch_bf16, three otherwise).  The main form (no stagger,
    no int8_win) reruns bit-equal; stagger is held bit-equal to K14 under the
    options `twin` (the same options without it: the main form, at a
    cluster of one CTA, whose sums are the walk's own order).  `plain_memo`
    as phase_step's."""
    from som_lvq_pak_torch.ops.som_step import (som_fused_factored_chunked_step,
                                                som_fused_factored_chunked_step_plain)

    if bf16:
        tols = dict(val_tol=(0.0, 5e-3), win_rel=1e-2)
    else:
        tols = dict(codes_tol=1e-5, val_tol=(0.0, 5e-3) if kw.get("batch_bf16")
                    else (1e-4, 1e-4))
    main = not (kw.get("stagger") or kw.get("int8_win"))
    with contextlib.nullcontext() if main else k14_cluster_forced(1):
        return phase_step(som_fused_factored_chunked_step,
                          som_fused_factored_chunked_step_plain, *case, seed=seed,
                          name=name, kw=kw, twin=kw if main else twin,
                          route_mult=1 if kw.get("batch_bf16") else 3, bf16=bf16,
                          plain_memo=plain_memo, **tols)


@contextlib.contextmanager
def k14_stagger_ctas(n: int):
    """K14's staggered grid capped at `n` CTAs (ops.som_step.
    K14_STAGGER_CTAS), so that each CTA walks several tiles."""
    from som_lvq_pak_torch.ops import som_step

    saved = som_step.K14_STAGGER_CTAS
    som_step.K14_STAGGER_CTAS = n
    try:
        yield
    finally:
        som_step.K14_STAGGER_CTAS = saved


@contextlib.contextmanager
def k15_splits_forced(splits: int):
    """K15's codebook split into `splits` spans in place of
    ops.winner_probe.k15_splits."""
    from som_lvq_pak_torch.ops import winner_probe

    saved = winner_probe.k15_splits
    winner_probe.k15_splits = lambda B, N, device: splits
    try:
        yield
    finally:
        winner_probe.k15_splits = saved


@contextlib.contextmanager
def k14_cluster_forced(c: int):
    """K14's main form on its Hopper walk with each tile's batch split
    across `c` CTAs (ops.som_step.K14_CLUSTER) in place of the wrapper's
    choice, k14_cluster."""
    from som_lvq_pak_torch.ops import som_step

    saved = som_step.K14_CLUSTER
    som_step.K14_CLUSTER = c
    try:
        yield
    finally:
        som_step.K14_CLUSTER = saved


def option_phases(recs):
    """K14's options, K15, K16 and K17 against their plain versions; fills
    their records in `recs` and returns K17's two records."""
    import torch

    from som_lvq_pak_torch.ops import winner_probe
    from som_lvq_pak_torch.ops.winner_probe import (f32_winner_probe,
                                                    f32_winner_probe_plain,
                                                    int8_winner_probe,
                                                    int8_winner_probe_plain)

    # K14's stagger (its walk on a persistent grid) at every K14 case and a
    # bf16 codebook: bit-equal to K14's main form on the same inputs, and
    # held against the plain version as K14 is; at 64x64 (64 tiles, one per
    # CTA on the resident grid) also on grids of 1 and 3 CTAs; its record at
    # int8_step_ab's step (256x256 B 4096, the bf16 x-pattern: 1024 tiles,
    # several per CTA)
    stag = [k14_step(case, seed, dict(kw, stagger=True), twin=kw)
            for case, seed, kw in K14_CASES]
    k14_step(*K14_BF16_CODEBOOK, dict(K14_BOTH, stagger=True), twin=K14_BOTH, bf16=True)
    case, seed, kw = K14_CASES[0]
    for ctas in (1, 3):
        with k14_stagger_ctas(ctas):
            stag.append(k14_step(case, seed, dict(kw, stagger=True), twin=kw,
                                 name=f"som_fused_factored_chunked_step ctas={ctas}"))
    recs["som_fused_factored_chunked_step[stagger]"] = dict(
        stag[1], max_abs_err=max(r["max_abs_err"] for r in stag))
    # K14's int8_win at int8_step_ab's step (its record), 64x64 with both bf16
    # options, 64x64 bubble, bf16 batches at the 256x256 B 8192 shape, and a
    # bf16 codebook
    i8 = [phase_int8(*case, seed=seed, kw=kw) for case, seed, kw in (
        ((256, 256, True, True, 4096, 64, 3.0), 53, dict(batch_chunk=1024, wxa_bf16=True)),
        ((64, 64, True, True, 4096, 64, 16.0), 54, K14_BOTH),
        ((64, 64, True, False, 4096, 64, 16.0), 55, dict(batch_chunk=1024)),
        ((256, 256, True, True, 8192, 64, 64.0), 56, K14_BOTH))]
    phase_int8(64, 64, True, True, 4096, 64, 16.0, seed=57, kw=K14_BOTH, bf16=True)
    recs["som_fused_factored_chunked_step[int8_win]"] = dict(
        i8[0], max_abs_err=max(r["max_abs_err"] for r in i8))
    # K15 and K16 at tools/int8_probe.py's winner shape (their records, with
    # the library call), a small ragged shape and every row twice
    for name, k, p, lib, dt in (
            ("int8_winner_probe", int8_winner_probe, int8_winner_probe_plain,
             lambda m, x: torch._int_mm(m, x).amax(0), torch.int8),
            ("f32_winner_probe", f32_winner_probe, f32_winner_probe_plain,
             lambda m, x: torch.mm(m, x).amax(0), torch.float32)):
        rs = [phase_probe(name, k, p, lib if seed == 60 else None, dt, *shape, seed=seed,
                          dup=dup)
              for shape, seed, dup in (((65536, 64, 4096), 60, False),
                                       ((999, 5, 1000), 61, False),
                                       ((1000, 5, 999), 62, True),
                                       ((1000, 130, 999), 66, False))]
        if dt == torch.float32:  # K16 on normal floats, held to PROBE_F32_REL
            r = phase_probe(name, k, p, None, dt, 65536, 64, 4096, seed=65, normal=True)
            rs[0] = dict(rs[0], max_rel_err_normal=r["max_rel_err"])
        recs[name] = rs[0]
    # K15 where its wgmma route can break: every maximum negative past a
    # ragged N (a zero-filled code must not win), -128 rows and columns, N
    # below one tile with B not a multiple of 64, one of each, D 256 (two
    # chunks of 128 bytes), D 37 (m copied padded), and the record shape
    # with its codebook splits forced to 1 and to its largest (one tile a CTA)
    for shape, seed, kind in (((1000, 64, 999), 67, "negative"), ((1000, 64, 999), 68, "min"),
                              ((200, 64, 100), 69, "random"), ((1, 1, 1), 75, "min"),
                              ((1000, 256, 999), 76, "random"), ((1000, 37, 999), 77, "negative")):
        phase_probe("int8_winner_probe", int8_winner_probe, int8_winner_probe_plain, None,
                    torch.int8, *shape, seed=seed, kind=kind, iters=3)
    for splits in (1, -(-65536 // winner_probe.K15_TILE)):
        with k15_splits_forced(splits):
            phase_probe("int8_winner_probe", int8_winner_probe, int8_winner_probe_plain, None,
                        torch.int8, 65536, 64, 4096, seed=60, iters=3,
                        label=f"int8_winner_probe 65536x64x4096 splits={splits}")
    # K17 at bench.py's twins of the headline steps: B 4096 float32 (its
    # record), B 8192 bf16; then both types at ragged shapes with an x' of
    # its own (D 5, 37, 130, 200: every width class; B not a multiple of 8:
    # W read element by element, an odd bf16 chunk)
    sk = [phase_skeleton(4096, False, seed=63), phase_skeleton(8192, True, seed=64)]
    small = [phase_skeleton(B, bf16, seed=70 + j, N=N, D=D, T=T, Bn=Bn, iters=3)
             for j, (N, D, T, B, Bn) in enumerate(((1000, 37, 100, 333, 257),
                                                  (777, 5, 64, 1000, 999),
                                                  (500, 130, 256, 513, 130),
                                                  (300, 200, 7, 64, 100)))
             for bf16 in (False, True)]
    recs["fused_step_skeleton"] = dict(
        sk[0], max_abs_err=max(r["max_abs_err"] for r in sk + small))
    return sk


def release():
    """Hand back what the phases before left: Python's garbage, then the
    CUDA caching allocator's unused blocks (the kernel phases' plain
    references take GiBs)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_update(kernel, plain, xdim, ydim, hexa, gaussian, B, D, radius, seed,
                 masked):
    """The two-kernel step's update (K5, or K6 with a mask) against its
    plain version: a few samples without a BMU, per-sample alphas; run twice
    on the same inputs, bit-equal.  K5's codebook must equal K3's
    (`som_fused_train_step(factored=False)`, K5 being K3's update half with
    its blend) on the same inputs bit for bit.  Both record the mean and max
    distance of their codebook and of the plain version's from the same
    blend taken in float64, and their split-TF32 route's bound (K5: 6 noc B
    D TF32 FLOPs, three products for W.X; K6: 10 noc B D, three for
    W.(X o K), two for W.K) and share.  library_ms is the plain version's
    time: it is the PyTorch call chain of the same function (neighborhood_w,
    then FP32 cuBLAS products and the blend)."""
    import torch

    from som_lvq_pak_torch.ops import som_step as ss
    from som_lvq_pak_torch.ops.dist_argmin import dist_argmin_plain

    noc = xdim * ydim
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randn((noc, D), generator=g, device="cuda")
    xb = torch.randn((B, D), generator=g, device="cuda")
    bmu = dist_argmin_plain(xb, codes)[1]
    bmu[:7] = -1  # samples without a BMU teach nothing
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device="cuda")
    extra = (random_mask(g, B, D, 0.1),) if masked else ()

    def run(fn, c):
        return fn(c, xb, bmu, *extra, xdim, hexa, alpha, radius, gaussian)

    ck = run(kernel, codes.clone())
    cp = run(plain, codes.clone())
    c2 = run(kernel, codes.clone())
    torch.cuda.synchronize()
    name = f"{kernel.__name__} {xdim}x{ydim} {'hexa' if hexa else 'rect'} " \
           f"{'gaussian' if gaussian else 'bubble'} D {D}"
    if not torch.allclose(ck, cp, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{name}: codebooks differ by {float((ck - cp).abs().max())}")
    if not torch.equal(ck.view(torch.int32), c2.view(torch.int32)):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    k3 = {}
    if not masked:  # K3's rows: any next batch, the codebook compared
        c3 = ss.som_fused_train_step(codes.clone(), xb, bmu, xb, xdim, hexa, alpha,
                                     radius, gaussian, factored=False)[0]
        torch.cuda.synchronize()
        if not torch.equal(ck.view(torch.int32), c3.view(torch.int32)):
            raise AssertionError(f"{name}: the codebook is not K3's on the same winners "
                                 "bit for bit")
        k3 = dict(bit_equal_to="som_fused_train_step(factored=False)")
        del c3
    # both codebooks against the blend taken in float64
    aw, r = ss._alpha_r(alpha, radius, B, "cuda")
    units = torch.arange(noc, dtype=torch.int32, device="cuda")
    w = ss.neighborhood_w(bmu, aw, r, units, xdim, hexa, gaussian).double()
    keep = (extra[0] == 0).double() if masked else torch.ones_like(xb, dtype=torch.float64)
    exact = ss.guarded_blend(codes.double(), w @ (xb.double() * keep), w @ keep)
    dk, dp = (ck.double() - exact).abs(), (cp.double() - exact).abs()
    f64 = dict(mean_abs_err_vs_f64=float(dk.mean()), max_abs_err_vs_f64=float(dk.max()),
               plain_mean_abs_err_vs_f64=float(dp.mean()),
               plain_max_abs_err_vs_f64=float(dp.max()))
    del w, keep, exact, dk, dp
    work = codes.clone()
    # W.X (and W.K with a mask), 2 noc B D FLOPs each
    rec = dict(kernel=name, shape=[noc, B, D], radius=radius,
               max_abs_err=float((ck - cp).abs().max()), bit_equal_rerun=True, **k3,
               **f64, ms=cuda_ms(lambda: run(kernel, work)),
               plain_ms=cuda_ms(lambda: run(plain, work)),
               **bound((4 if masked else 2) * noc * B * D,
                       8 * noc * D + 4 * B * D + masked * B * D + 8 * B,
                       route_flops=(10 if masked else 6) * noc * B * D))
    rec.update(route_pct(rec))
    emit("kernels", **rec)
    return rec


def phase_update_bubble_boundary():
    """The exact bubble boundary through K6 on the card: on an 8x6 hexa map
    a sample with BMU (column 2, row 0), alpha 0.5 and r = 3 reaches the
    unit (column 3, row 3) at d2 = r^2 exactly; the unit's unmasked
    components must become 0.5 exactly and its masked one stay 0, the
    codebook equal to the plain version's bit for bit."""
    import torch

    from som_lvq_pak_torch.ops.som_update import (som_neighborhood_update_idx_masked,
                                                  som_neighborhood_update_idx_plain)

    xdim, D, inside = 8, 64, 3 * 8 + 3
    xb = torch.ones((1, D), device="cuda")
    bmu = torch.full((1,), 2, dtype=torch.int32, device="cuda")
    mask = torch.zeros((1, D), dtype=torch.uint8, device="cuda")
    mask[0, 1::3] = 1
    ck = som_neighborhood_update_idx_masked(torch.zeros((48, D), device="cuda"), xb, bmu,
                                            mask, xdim, True, 0.5, 3.0, False)
    cp = som_neighborhood_update_idx_plain(torch.zeros((48, D), device="cuda"), xb, bmu,
                                           xdim, True, 0.5, 3.0, False, mask=mask)
    torch.cuda.synchronize()
    want = torch.where(mask[0] != 0, 0.0, 0.5)
    if not (torch.equal(ck, cp) and torch.equal(ck[inside], want)):
        raise AssertionError("K6: the exact bubble boundary went wrong: "
                             f"{ck[inside, :4].tolist()}")
    emit("kernels", kernel="exact bubble boundary, K6", inside_equals_half=True,
         equal_plain=True)


@contextlib.contextmanager
def k7_rows_forced(rows: int):
    """K7 past D 128 (the mma.sync kernel) at `rows` codebook rows per CTA,
    whatever ops.som_vmem.k7_rows picks."""
    from som_lvq_pak_torch.ops import som_vmem

    saved = som_vmem.k7_rows
    som_vmem.k7_rows = lambda *_: (rows, 1)
    try:
        yield
    finally:
        som_vmem.k7_rows = saved


@contextlib.contextmanager
def k7_cluster_forced(cluster: int):
    """K7's walk (D <= 128) at `cluster` CTAs a tile, whatever
    ops.som_vmem.k7_rows picks."""
    from som_lvq_pak_torch.ops import som_vmem

    saved = som_vmem.K7_CLUSTER
    som_vmem.K7_CLUSTER = cluster
    try:
        yield
    finally:
        som_vmem.K7_CLUSTER = saved


K7_ROWS = (16, 32, 64)


def phase_vmem(xdim, ydim, hexa, gaussian, D, B, K, radius, alpha, seed,
               varied=False, dup=False, k13=False, rows=False):
    """K7 against its plain version at one group shape: K steps of B samples,
    next_first given.  Constant alpha and radius (bench.py's), or with
    `varied` per-sample alphas and a decaying radius.  First with zero
    alphas: the codebook must stay bit-equal to its input (with `dup`, every
    code there three times, the first copy must win).  Then the codebook
    and bmu_next must be bit-equal to K chained K3 launches
    (som_fused_train_step(..., factored=False)) and to a rerun; the record
    carries k3_chain_ms (and with `k13` k13_chain_ms, K chained K13 steps,
    the trainer's per-step kernel at that shape) and the split-TF32 route's
    bound (12 noc B D K TF32 FLOPs).  With `rows`, up to D 128 K7's walk at
    every cluster size of `ops.som_vmem.k7_clusters` whose grid the card
    holds at once, each bit-equal to the K3 chain, and one "k7_cluster"
    line of the wrapper's pick and each size's ms by CUDA events over
    back-to-back launches ("not resident" for a size whose grid the card
    cannot hold: the wrapper never picks it); past D 128 the mma.sync
    kernel at every height of K7_ROWS, likewise, in one "k7_rows" line."""
    import torch

    from som_lvq_pak_torch.ops import som_vmem
    from som_lvq_pak_torch.ops.dist_argmin import dist_argmin_plain
    from som_lvq_pak_torch.ops.som_step import (som_fused_factored_step,
                                                som_fused_train_step)
    from som_lvq_pak_torch.ops.som_vmem import (som_vmem_train_steps,
                                                som_vmem_train_steps_plain)

    noc = xdim * ydim
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dup:
        base = torch.randn((noc // 3, D), generator=g, device="cuda")
        codes = torch.cat([base, base, base]).contiguous()
    else:
        codes = torch.randn((noc, D), generator=g, device="cuda")
    xs = torch.randn((K, B, D), generator=g, device="cuda")
    nf = torch.randn((B, D), generator=g, device="cuda")
    bmu0 = dist_argmin_plain(xs[0], codes)[1]
    if varied:
        alphas = alpha * (0.5 + torch.rand((K, B), generator=g, device="cuda"))
        radii = torch.linspace(radius, max(1.0, radius / 2), K, device="cuda")
    else:
        alphas = torch.full((K,), alpha, device="cuda")
        radii = torch.full((K,), radius, device="cuda")
    name = f"som_vmem_train_steps {xdim}x{ydim} {'hexa' if hexa else 'rect'} " \
           f"{'gaussian' if gaussian else 'bubble'}"
    rlist = radii.tolist()

    def k7(fn, c, a=alphas):
        return fn(c, xs, bmu0, a, radii, xdim, hexa, gaussian, next_first=nf)

    def chain(step, c):
        bmu = bmu0
        for t in range(K):
            _, bmu, _ = step(c, xs[t], bmu, xs[t + 1] if t + 1 < K else nf, xdim, hexa,
                             alphas[t], rlist[t], gaussian)
        return c, bmu

    def k3_step(*a):
        return som_fused_train_step(*a, factored=False)

    def bit_equal(c, i, c_ref, i_ref):
        return torch.equal(c.view(torch.int32), c_ref.view(torch.int32)) and \
            torch.equal(i, i_ref)

    c0, i0 = k7(som_vmem_train_steps, codes.clone(), torch.zeros_like(alphas))
    torch.cuda.synchronize()
    if not torch.equal(c0.view(torch.int32), codes.view(torch.int32)):
        raise AssertionError(f"{name}: with zero alphas the codebook moved")
    if dup and int(i0.max()) >= noc // 3:
        raise AssertionError(f"{name}: a duplicate row beat its first copy")
    ck, ik = k7(som_vmem_train_steps, codes.clone())
    cr, ir = k7(som_vmem_train_steps, codes.clone())
    cp, ip = k7(som_vmem_train_steps_plain, codes.clone())
    c3, i3 = chain(k3_step, codes.clone())
    torch.cuda.synchronize()
    if not bit_equal(cr, ir, ck, ik):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    if not torch.allclose(ck, cp, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{name}: codebooks differ by {float((ck - cp).abs().max())}")
    n_diff = check_winners(name, nf, ck, ik, ip)
    diff3, flips3 = float((ck - c3).abs().max()), int((ik != i3).sum())
    if not bit_equal(ck, ik, c3, i3):
        raise AssertionError(f"{name}: not bit-equal to {K} chained K3 launches: "
                             f"codebooks differ by {diff3}, {flips3} winners")
    rec = dict(kernel=name, shape=[noc, B, D, K], radius=radius, alpha=alpha,
               varied=varied, dup=dup, winners_differ=n_diff,
               max_abs_err=float((ck - cp).abs().max()), max_abs_diff_vs_k3=diff3,
               winners_differ_vs_k3=flips3, bit_equal_rerun=True,
               bit_equal_to="K chained som_fused_train_step(factored=False)",
               zero_alpha_bit_equal=True,
               rows_cluster=list(som_vmem.k7_rows(noc, D, codes.device, B)),
               route=som_vmem.k7_route(D))
    work = codes.clone()
    # K steps of update W.X and winners, 2 noc B D FLOPs each; the codebook
    # read and written once, the batches, next_first, alphas, radii and bmu0
    # read, the next winners written; the route: three TF32 products each
    rec.update(ms=cuda_ms(lambda: k7(som_vmem_train_steps, work)),
               plain_ms=cuda_ms(lambda: k7(som_vmem_train_steps_plain, work), 3),
               **bound(4 * noc * B * D * K,
                       8 * noc * D + 4 * (K + 1) * B * D + 4 * K * B + 4 * K + 8 * B,
                       route_flops=12 * noc * B * D * K))
    rec.update(route_pct(rec))
    rec["k3_chain_ms"] = cuda_ms(lambda: chain(k3_step, work))
    if k13:
        rec["k13_chain_ms"] = cuda_ms(lambda: chain(som_fused_factored_step, work))
    emit("kernels", **rec)
    if rows:
        walk = som_vmem.k7_route(D) == "sm90"
        rows_now, c_now = som_vmem.k7_rows(noc, D, codes.device, B)
        line = dict(card=nvidia_smi_line(), shape=rec["shape"])
        if walk:
            line["k7_cluster_chosen"] = c_now
            tiles = -(-noc // som_vmem.K7_TILE)
            forced = [(f"k7_c{c}_ms", k7_cluster_forced(c),
                       som_vmem._k7_resident(D, c) >= tiles)
                      for c in som_vmem.k7_clusters(D)]
        else:
            line["k7_rows_chosen"] = rows_now
            forced = [(f"k7_rows{r}_ms", k7_rows_forced(r), True) for r in K7_ROWS]
        for key, ctx, resident in forced:
            if not resident:
                line[key] = "not resident"
                continue
            with ctx:
                cf, i_f = k7(som_vmem_train_steps, codes.clone())
                torch.cuda.synchronize()
                if not bit_equal(cf, i_f, c3, i3):
                    raise AssertionError(f"{name} at {key[:-3]}: not bit-equal to {K} "
                                         "chained K3 launches")
                line[key] = cuda_ms(lambda: k7(som_vmem_train_steps, work))
        emit("k7_cluster" if walk else "k7_rows", **line, k3_chain_ms=rec["k3_chain_ms"],
             **({"k13_chain_ms": rec["k13_chain_ms"]} if k13 else {}))
    return rec


def bits_equal(a, b) -> bool:
    """The same floats (or integers) bit for bit, -0 and NaN payloads too."""
    import torch

    a, b = a.contiguous(), b.contiguous()
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_topk(B, N, D, k, seed, dup=False, iters=10, library=False):
    """K10 against its plain version (ops.distance.topk_winners): each of
    the k index columns equal except at near-ties, values within 1e-4.  With
    `dup` every code is there twice: every index must equal the plain
    version's, and each sample's neighbours come as (row, copy) pairs.  The
    kernel runs twice on the same inputs, bit-equal; its column 0 must be
    K1's (dist_argmin) (value, index) bit for bit and, at k = 2, its columns
    K8's (dist_top2) pairs.  The record carries its split-TF32 route's bound
    (6 B N D TF32 FLOPs) and share; with `library`, the library_ms of addmm
    then topk(k)."""
    import torch

    from som_lvq_pak_torch.ops.dist_argmin import dist_argmin
    from som_lvq_pak_torch.ops.dist_top2 import dist_top2
    from som_lvq_pak_torch.ops.dist_topk import dist_topk, dist_topk_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, D), generator=g, device="cuda")
    if dup:
        base = torch.randn((N // 2, D), generator=g, device="cuda")
        codes = torch.cat([base, base]).contiguous()
    else:
        codes = torch.randn((N, D), generator=g, device="cuda")
    vk, ik = dist_topk(x, codes, k)
    va, ia = dist_topk(x, codes, k)
    vp, ip = dist_topk_plain(x, codes, k)
    v1, i1 = dist_argmin(x, codes)
    top2 = dist_top2(x, codes) if k == 2 else None
    torch.cuda.synchronize()
    name = f"dist_topk k={k}"
    if not (bits_equal(vk, va) and torch.equal(ik, ia)):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    if not (bits_equal(vk[:, 0], v1) and torch.equal(ik[:, 0], i1)):
        raise AssertionError(f"{name}: column 0 is not dist_argmin's (value, index) "
                             "bit for bit")
    if top2 is not None and not all(
            bits_equal(vk[:, c], top2[2 * c]) and torch.equal(ik[:, c], top2[2 * c + 1])
            for c in (0, 1)):
        raise AssertionError(f"{name}: the pairs are not dist_top2's bit for bit")
    n_diff = sum(check_winners(f"{name} column {j}", x, codes, ik[:, j], ip[:, j])
                 for j in range(k))
    err = float((vk - vp).abs().max())
    if not torch.allclose(vk, vp, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{name}: values differ by {err}")
    if dup:
        half = codes.shape[0] // 2
        if not torch.equal(ik, ip):
            raise AssertionError(f"{name}: exact ties resolved unlike the plain version")
        if k >= 2 and not torch.equal(ik[:, 1].long(), ik[:, 0].long() + half):
            raise AssertionError(f"{name}: a copy beat its first row")
    # (B, D) samples and (N, D) codes in, (B, k) values and indices out
    rec = dict(kernel=name, shape=[B, codes.shape[0], D], k=k,
               km=min(m for m in (2, 4, 8, 16) if m >= k), dup=dup,
               winners_differ=n_diff, max_abs_err=err, bit_equal_rerun=True,
               column0_bit_equal_to="dist_argmin",
               **({} if top2 is None else {"bit_equal_to": "dist_top2"}),
               ms=cuda_ms(lambda: dist_topk(x, codes, k), iters),
               plain_ms=cuda_ms(lambda: dist_topk_plain(x, codes, k), iters),
               **bound(2 * B * codes.shape[0] * D,
                       4 * (B * D + codes.shape[0] * D) + 8 * B * k,
                       route_flops=6 * B * codes.shape[0] * D))
    rec.update(route_pct(rec))
    if library:
        rec["library_ms"] = cuda_ms(lambda: library_winners(x, codes, "topk", k), iters)
    emit("kernels", **rec)
    return rec


def phase_topk_reference(B, N, D, k, seed, dup=False, iters=10):
    """K10 in the reference tie order (ops.dist_topk.dist_topk_reference:
    K10 on the codebook in reverse row order, each index mapped back as
    N - 1 - i), the host tools' kNN on the card: its indices equal the
    plain reference_ties path's (ops.distance.topk_winners) except at
    near-ties, exactly with every code twice, the later copy first; its
    values are K10's on the codebook in file order bit for bit (a pair's
    float does not depend on the code's row), and on two halves of the
    codebook merged by (value, index) (a walk over other splits), and the
    query rows in four chunks give the whole run's bits.  Returns the
    record."""
    import torch

    from som_lvq_pak_torch.ops.dist_topk import dist_topk, dist_topk_reference
    from som_lvq_pak_torch.ops.distance import topk_winners

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, D), generator=g, device="cuda")
    if dup:
        base = torch.randn((N // 2, D), generator=g, device="cuda")
        codes = torch.cat([base, base]).contiguous()
    else:
        codes = torch.randn((N, D), generator=g, device="cuda")
    name = f"dist_topk_reference k={k}" + (" dup" if dup else "")
    rev = codes.flip(0)  # the codebook reversed once, as chunked_topk does
    vr, ir = dist_topk_reference(x, rev, k)
    it, vt = topk_winners(x, codes, k, reference_ties=True)
    vk, ik = dist_topk(x, codes, k)
    torch.cuda.synchronize()
    n_diff = sum(check_winners(f"{name} column {j}", x, codes, ir[:, j], it[:, j])
                 for j in range(k))
    err = float((vr - torch.clamp(vt, min=0.0)).abs().max())
    if not torch.allclose(vr, torch.clamp(vt, min=0.0), rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{name}: values differ from the plain version by {err}")
    # the same (query, code) floats whichever row the code sits at
    if not bits_equal(vr, vk):
        raise AssertionError(f"{name}: the reversed codebook's values are not K10's "
                             "in file order bit for bit")
    if dup:
        half = N // 2
        if not torch.equal(ir.long(), it):
            raise AssertionError(f"{name}: exact ties resolved unlike the plain "
                                 "reference order")
        # file order: the first copy first; reference order: the later copy
        shift = torch.tensor([half if c % 2 == 0 else -half for c in range(k)],
                             device="cuda")
        if not torch.equal(ir.long(), ik.long() + shift):
            raise AssertionError(f"{name}: the later copy did not come first")
    elif not torch.equal(ir, ik):
        raise AssertionError(f"{name}: the reversed codebook's winners are not K10's")
    # the codebook walked as two halves, merged by (value, index)
    h = N // 2
    va, ia = dist_topk_reference(x, codes[:h].flip(0), k)
    vb, ib = dist_topk_reference(x, codes[h:].flip(0), k)
    cv, ci = torch.cat([va, vb], 1), torch.cat([ia, ib + h], 1).long()
    o = torch.argsort(-ci, dim=1, stable=True)  # index descending among equal values
    cv, ci = cv.gather(1, o), ci.gather(1, o)
    o = torch.argsort(cv, dim=1, stable=True)[:, :k]
    if not (bits_equal(cv.gather(1, o), vr) and torch.equal(ci.gather(1, o), ir.long())):
        raise AssertionError(f"{name}: the two halves merged differ from the whole walk")
    # the queries in four chunks (other splits of the codebook per launch)
    parts = [dist_topk_reference(xc.contiguous(), rev, k) for xc in x.chunk(4)]
    if not (bits_equal(torch.cat([p[0] for p in parts]), vr)
            and torch.equal(torch.cat([p[1] for p in parts]), ir)):
        raise AssertionError(f"{name}: query chunks differ from the whole run")
    rec = dict(kernel=name, shape=[B, N, D], k=k, dup=dup, winners_differ=n_diff,
               max_abs_err=err, bit_equal_to_file_order=True, halves_merged_bit_equal=True,
               query_chunks_bit_equal=True,
               ms=cuda_ms(lambda: dist_topk_reference(x, rev, k), iters),
               file_order_ms=cuda_ms(lambda: dist_topk(x, codes, k), iters),
               plain_ms=cuda_ms(lambda: topk_winners(x, codes, k, reference_ties=True), iters))
    emit("kernels", **rec)
    return rec


def shard_inputs(g, noc, n_local, B, D):
    """A model shard's inputs: a batch, its global BMUs over the whole map
    (a few samples without one) and per-sample alphas."""
    import torch

    xb = torch.randn((B, D), generator=g, device="cuda")
    bmu = torch.randint(0, noc, (B,), generator=g, device="cuda", dtype=torch.int32)
    bmu[:7] = -1  # samples without a BMU teach nothing
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device="cuda")
    return xb, bmu, alpha


def phase_accum(xdim, hexa, gaussian, n_local, offset, B, D, radius, per_sample,
                seed):
    """K11 on the rows offset .. offset + n_local - 1 of an xdim x xdim map
    against its plain version: acc and wsum within 1e-4 relative, 1e-5 of
    the largest accumulator absolute (the kernel sums the batch in order,
    the plain version's matmul in its own order); a rerun bit-equal, and
    the shard accumulated in two row segments split 8 rows short of its
    middle (the mesh step's overlap_segments takes any 8-row-aligned split)
    bit-equal to it whole.  Its route's bound: W.X as three TF32 products,
    6 n_local B D FLOPs."""
    import torch

    from som_lvq_pak_torch.ops.som_accum import (som_neighborhood_accumulate,
                                                 som_neighborhood_accumulate_plain)

    g = torch.Generator(device="cuda").manual_seed(seed)
    xb, bmu, alpha = shard_inputs(g, xdim * xdim, n_local, B, D)
    a = alpha if per_sample else 0.05

    def run(fn):
        return fn(xb, bmu, n_local, xdim, hexa, a, radius, gaussian, unit_offset=offset)

    ak, wk = run(som_neighborhood_accumulate)
    ak2, wk2 = run(som_neighborhood_accumulate)
    ap, wp = run(som_neighborhood_accumulate_plain)
    cut = n_local // 2 // 8 * 8 - 8 if n_local >= 32 else 0
    segs = [som_neighborhood_accumulate(xb, bmu, h, xdim, hexa, a, radius, gaussian,
                                        unit_offset=offset + o)
            for o, h in ((0, cut), (cut, n_local - cut)) if h > 0]
    torch.cuda.synchronize()
    name = (f"som_neighborhood_accumulate {xdim}x{xdim}[{offset}:{offset + n_local}] "
            f"{'hexa' if hexa else 'rect'} {'gaussian' if gaussian else 'bubble'} "
            f"{'per-sample' if per_sample else 'scalar'} alpha")
    if not (torch.equal(ak, ak2) and torch.equal(wk, wk2)):
        raise AssertionError(f"{name}: a rerun is not bit-equal")
    if not (torch.equal(torch.cat([s_[0] for s_ in segs]), ak)
            and torch.equal(torch.cat([s_[1] for s_ in segs]), wk)):
        raise AssertionError(f"{name}: two row segments (split at {cut}) are not "
                             "bit-equal to the whole shard")
    err = max(float((ak - ap).abs().max()), float((wk - wp).abs().max()))
    for got, want in ((ak, ap), (wk, wp)):
        if not torch.allclose(got, want, rtol=1e-4,
                              atol=1e-5 * max(1.0, float(want.abs().max()))):
            raise AssertionError(f"{name}: accumulators differ by {err}")
    if float(wp.max()) <= 0:
        raise AssertionError(f"{name}: no unit of the shard took any weight")
    # (B, D) samples, bmu and alpha in; (n_local, D) acc and (n_local,) wsum
    # out; 2 n_local B D FLOPs
    rec = dict(kernel=name, shape=[n_local, B, D], radius=radius, max_abs_err=err,
               rerun_bit_equal=True, segments_bit_equal=True, segment_cut=cut,
               ms=cuda_ms(lambda: run(som_neighborhood_accumulate)),
               plain_ms=cuda_ms(lambda: run(som_neighborhood_accumulate_plain)),
               **bound(2 * n_local * B * D, 4 * B * D + 8 * B + 4 * n_local * (D + 1),
                       route_flops=6 * n_local * B * D))
    rec.update(route_pct(rec))
    emit("kernels", **rec)
    return rec


def phase_blend(n_local, D, Bn, seed, dup=False):
    """K12 against its plain version: the blended shard within 1e-5, the
    next batch's winners equal except at near-ties, values within 1e-4.
    With `dup` every row (and its accumulators) is there twice: the first
    copy must win every exact tie.  Two runs on the same inputs must be
    bit-equal (codebook, values, winners).  The record carries its
    split-TF32 route's bound (the scores as three TF32 products, 6 n_local
    B' D FLOPs) and share."""
    import torch

    from som_lvq_pak_torch.ops.som_blend import som_blend_winner, som_blend_winner_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = n_local // 2 if dup else n_local
    codes = torch.randn((rows, D), generator=g, device="cuda")
    wsum = 2.0 * torch.rand((rows, 1), generator=g, device="cuda")
    acc = wsum * torch.randn((rows, D), generator=g, device="cuda")
    if dup:
        codes, acc, wsum = (torch.cat([t, t]).contiguous() for t in (codes, acc, wsum))
    xn = torch.randn((Bn, D), generator=g, device="cuda")
    ck, vk, ik = som_blend_winner(codes.clone(), acc, wsum, xn)
    ca, va, ia = som_blend_winner(codes.clone(), acc, wsum, xn)
    cp, vp, ip = som_blend_winner_plain(codes.clone(), acc, wsum, xn)
    torch.cuda.synchronize()
    name = f"som_blend_winner {n_local}x{D} B' {Bn}" + (" every row twice" if dup else "")
    if not (bits_equal(ck, ca) and bits_equal(vk, va) and torch.equal(ik, ia)):
        raise AssertionError(f"{name}: two runs on the same inputs differ")
    if not torch.allclose(ck, cp, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name}: codebooks differ by {float((ck - cp).abs().max())}")
    n_diff = check_winners(name, xn, ck, ik, ip)
    if not torch.allclose(vk, vp, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{name}: winner values differ by {float((vk - vp).abs().max())}")
    if dup and int(ik.max()) >= rows:
        raise AssertionError(f"{name}: a duplicate row beat its first copy")
    work = codes.clone()
    # codes read and written, acc, wsum and the next batch read, the winners
    # written; 2 n_local B' D FLOPs for the scores
    rec = dict(kernel=name, shape=[n_local, Bn, D], dup=dup, winners_differ=n_diff,
               max_abs_err=max(float((ck - cp).abs().max()), float((vk - vp).abs().max())),
               bit_equal_rerun=True,
               ms=cuda_ms(lambda: som_blend_winner(work, acc, wsum, xn)),
               plain_ms=cuda_ms(lambda: som_blend_winner_plain(work, acc, wsum, xn)),
               **bound(2 * n_local * Bn * D, 12 * n_local * D + 4 * n_local + 4 * Bn * D + 8 * Bn,
                       route_flops=6 * n_local * Bn * D))
    rec.update(route_pct(rec))
    emit("kernels", **rec)
    return rec


def phase_shard_step(xdim, hexa, gaussian, B, D, radius, seed):
    """One step on each model-shard half of an xdim x xdim map against the
    unsharded step on the same inputs: K3 with the half's unit offset must
    give the unsharded K3's rows bit for bit, and the gather-min of the two
    halves' winners (global rows, lowest on ties) its winners; K11 then K12
    on the half (one data shard) must give its K3 step's rows, values and
    winners bit for bit (K11 is K3's update half, K12 its blend-and-winner
    half)."""
    import torch

    from som_lvq_pak_torch.ops.som_accum import som_neighborhood_accumulate
    from som_lvq_pak_torch.ops.som_blend import som_blend_winner
    from som_lvq_pak_torch.ops.som_step import som_fused_train_step

    noc, half = xdim * xdim, xdim * xdim // 2
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randn((noc, D), generator=g, device="cuda")
    xb, bmu, alpha = shard_inputs(g, noc, half, B, D)
    xn = torch.randn((B, D), generator=g, device="cuda")
    args = (xdim, hexa, alpha, radius, gaussian)
    full, i_full, v_full = som_fused_train_step(codes.clone(), xb, bmu, xn, *args,
                                                factored=False)
    parts = [som_fused_train_step(codes[m * half:(m + 1) * half].clone(), xb, bmu, xn,
                                  *args, unit_offset=m * half) for m in (0, 1)]
    vals = torch.stack([v for _, _, v in parts])
    gidx = torch.stack([i + m * half for m, (_, i, _) in enumerate(parts)])
    best = vals.min(0).values
    won = torch.where(vals == best[None], gidx, torch.iinfo(torch.int32).max).min(0).values
    acc, wsum = som_neighborhood_accumulate(xb, bmu, half, xdim, hexa, alpha, radius,
                                            gaussian, unit_offset=half)
    c12, v12, i12 = som_blend_winner(codes[half:].clone(), acc, wsum, xn)
    torch.cuda.synchronize()
    name = f"som_fused_train_step {xdim}x{xdim} in two shards"
    shards = torch.cat([c for c, _, _ in parts])
    if not (torch.equal(shards, full) and torch.equal(won, i_full)
            and torch.equal(best, v_full)):
        raise AssertionError(f"{name}: the shards differ from the unsharded step by "
                             f"{float((shards - full).abs().max())}, "
                             f"{int((won != i_full).sum())} winners")
    c3, i3, v3 = parts[1]
    if not (bits_equal(c12, c3) and bits_equal(v12, v3) and torch.equal(i12, i3)):
        raise AssertionError(
            f"{name}: K11 + K12 differ from K3: codebook by "
            f"{float((c12 - c3).abs().max())}, values by {float((v12 - v3).abs().max())}, "
            f"{int((i12 != i3).sum())} winners")
    emit("kernels", kernel=name, shape=[noc, B, D], radius=radius,
         shards_equal_unsharded=True, k11_k12_bit_equal_k3=["codes", "val", "idx"])


def blob_data(seed: int, n: int, n_centres: int, dim: int = 64):
    """bench.py's e2e data: gaussian clusters around N(0, 4) centres, `dim`
    features (64, bench.py's)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4.0, size=(n_centres, dim)).astype(np.float32)
    return (centres[rng.integers(0, n_centres, size=n)]
            + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32))


@contextlib.contextmanager
def plain_kernels():
    """Route the trainers, the fused step (its K3, K13 and K14 branches), the
    two-kernel step (and so som_train_fast and vfind_trials), the LVQ steps
    (their winners and segment sums), the online scan, the qerror, the
    qerror2, the accuracy and the confusion matrix, the per-sample LVQ scans
    and the host tools' kNN (K10 in the reference order) through the plain
    versions (for the reference run on the card); restores the kernels on
    exit."""
    from som_lvq_pak_torch.models import eval as ev
    from som_lvq_pak_torch.models import fast, lvq, som, trainer
    from som_lvq_pak_torch.ops import dist_argmin as da
    from som_lvq_pak_torch.ops import dist_top2 as dt
    from som_lvq_pak_torch.ops import dist_topk as dk
    from som_lvq_pak_torch.ops import segment_sum as ss
    from som_lvq_pak_torch.ops import som_step, som_update, som_vmem

    swaps = [(trainer, "dist_argmin", da.dist_argmin_plain),
             (som_step, "_fused_step_k3", som_step.som_fused_train_step_plain),
             (som_step, "_fused_step_separable", som_step._separable_plain),
             (trainer, "som_vmem_train_steps", som_vmem.som_vmem_train_steps_plain),
             (fast, "dist_argmin", da.dist_argmin_plain),
             (fast, "som_neighborhood_update_idx",
              som_update.som_neighborhood_update_idx_plain),
             (fast, "dist_top2", dt.dist_top2_plain),
             (fast, "segment_sum", ss.segment_sum_plain),
             (som, "dist_argmin", da.dist_argmin_plain),
             (som, "dist_argmin_t", da.dist_argmin_t_plain),
             (ev, "dist_argmin", da.dist_argmin_plain),
             (lvq, "dist_argmin", da.dist_argmin_plain),
             (lvq, "dist_top2", dt.dist_top2_plain),
             (dk, "dist_topk", dk.dist_topk_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def counted():
    from som_lvq_pak_torch.ops.dist_argmin import (dist_argmin, dist_argmin_masked,
                                                   dist_argmin_t, split_codes)
    from som_lvq_pak_torch.ops.skeleton import fused_step_skeleton
    from som_lvq_pak_torch.ops.som_step import (CHUNKED_INT8_WIN, CHUNKED_STAGGER,
                                                som_fused_factored_chunked_step,
                                                som_fused_factored_step,
                                                som_fused_train_step)
    from som_lvq_pak_torch.ops.som_update import (som_neighborhood_update_idx,
                                                  som_neighborhood_update_idx_masked)
    from som_lvq_pak_torch.ops.dist_top2 import dist_top2, dist_top2_masked
    from som_lvq_pak_torch.ops.dist_topk import dist_topk
    from som_lvq_pak_torch.ops.segment_sum import segment_sum
    from som_lvq_pak_torch.ops.som_accum import som_neighborhood_accumulate
    from som_lvq_pak_torch.ops.som_blend import som_blend_winner
    from som_lvq_pak_torch.ops.som_vmem import som_vmem_train_steps
    from som_lvq_pak_torch.ops.winner_probe import f32_winner_probe, int8_winner_probe

    return (dist_argmin, dist_argmin_t, som_fused_train_step, dist_argmin_masked,
            som_neighborhood_update_idx, som_neighborhood_update_idx_masked,
            som_vmem_train_steps, dist_top2, dist_top2_masked, dist_topk,
            som_neighborhood_accumulate, som_blend_winner, som_fused_factored_step,
            som_fused_factored_chunked_step, CHUNKED_INT8_WIN, CHUNKED_STAGGER,
            int8_winner_probe, f32_winner_probe, fused_step_skeleton, segment_sum,
            split_codes)


def with_prologue(kernels) -> tuple:
    """`kernels`, and K1's and K2's prologue (split_codes) wherever K1, K2 or
    K8 is among them: every K1, K2 or K8 call launches it first."""
    kernels = tuple(kernels)
    return kernels + (("split_codes",) if {"dist_argmin", "dist_argmin_t", "dist_top2"}
                      & set(kernels) else ())


def main_path(name, run, kernels, plain_run=None):
    """Run one main path with every launch counter set to 0 first; each of
    `kernels` must have launched, and K1's and K2's prologue (split_codes)
    wherever K1, K2 or K8 is among them.  `plain_run`, if given, runs the same
    path through the plain versions and must launch nothing.  Returns
    (result, plain result, launches)."""
    fns = counted()
    for fn in fns:
        fn.launches = 0
    out = run()
    launches = {fn.__name__: fn.launches for fn in fns}
    idle = [k for k in with_prologue(kernels) if launches[k] == 0]
    if idle:
        raise AssertionError(f"{name}: kernels of the path never launched: {idle}")
    ref = None
    if plain_run is not None:
        for fn in fns:
            fn.launches = 0
        with plain_kernels():
            ref = plain_run()
        if any(fn.launches for fn in fns):
            raise AssertionError(f"{name}: the plain run launched a kernel")
    return out, ref, launches


def random_codes(X, map_dim, mask=None):
    from som_lvq_pak_torch.models.som import (CRandom, Dataset, Neighborhood,
                                              Topology, randinit)

    crng = CRandom()
    crng.init_random(123)
    return randinit(Dataset(points=X, mask=mask), topol=Topology.HEXA,
                    neigh=Neighborhood.GAUSSIAN, xdim=map_dim, ydim=map_dim,
                    rng=crng)


def som_stream(X, chunk, total, mask=None, weight=None, labels=None):
    """Chunks of `chunk` rows of X (with their slices of mask, weight= and
    labels), from row 0 and wrapping around, until `total` samples."""
    from som_lvq_pak_torch.models.som import Dataset

    n, sent = X.shape[0], 0
    while sent < total:
        lo = sent % n
        sl = slice(lo, min(lo + chunk, n))
        yield Dataset(points=X[sl], mask=None if mask is None else mask[sl],
                      weight=None if weight is None else weight[sl],
                      labels=None if labels is None else labels[sl])
        sent += sl.stop - lo


def e2e(X, map_dim, bs, radius, chunk, mask=None, weight=None, vmem_steps=None,
        around=None, keep=None, **trainer_kw):
    """One streamed lap of SOMTrainer.fit, then find_qerror(fast) on a
    device-resident copy; returns (per-sample qerror, train_s, eval_s).
    With `mask`, chunks carry their slice of it (a Dataset drops an
    all-zero mask, so clean chunks have none) and the qerror is masked;
    with `weight`, chunks carry weight= tokens and training uses them.
    `vmem_steps` goes to SOMTrainer (False: never the grouped path), as do
    `trainer_kw` (bf16=, stream_bf16=).  `around(part)`, if given, is a context manager entered around the timed
    "train" and "eval" parts.  `keep`, a dict, receives the trained
    codebook under "codes"."""
    import torch

    from som_lvq_pak_torch.models.som import find_qerror
    from som_lvq_pak_torch.models.trainer import SOMTrainer

    n = X.shape[0]

    def stream(total):
        return som_stream(X, chunk, total, mask=mask, weight=weight)

    codes = random_codes(X, map_dim, mask)
    X_dev = torch.from_numpy(X).to("cuda")
    mk_dev = None if mask is None else torch.from_numpy(mask).to("cuda")
    kw = dict(alpha=0.05, radius=radius, allow_short_stream=True,
              use_weights=weight is not None)
    warm = SOMTrainer(codes, batch_size=bs, device="cuda", vmem_steps=vmem_steps,
                      **trainer_kw)
    find_qerror(warm.fit(stream(2 * bs), rlen=2 * bs, **kw), X_dev, mask=mk_dev)
    torch.cuda.synchronize()

    around = around or (lambda part: contextlib.nullcontext())
    tr = SOMTrainer(codes, batch_size=bs, device="cuda", vmem_steps=vmem_steps,
                    **trainer_kw)
    with around("train"):
        t0 = time.perf_counter()
        out = tr.fit(stream(n), rlen=n, **kw)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    with around("eval"):
        t0 = time.perf_counter()
        q = find_qerror(out, X_dev, mask=mk_dev) / n
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    if not np.isfinite(out.points).all() or out.points.shape != (map_dim * map_dim,
                                                                  X.shape[1]):
        raise AssertionError("trained codebook is not finite or has the wrong shape")
    if keep is not None:
        keep["codes"] = out
    return q, train_s, eval_s


def lvq_data(n: int = 1_000_000, seed: int = 11):
    """Labelled vectors (default_rng(seed)): 32 centres at N(0, 0.4) per
    component, unit-variance noise, class = centre index mod 8; returns the
    points, the label ids 1-8, and a label table naming them "c1".."c8"."""
    from som_lvq_pak_torch.data.labels import LabelTable

    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 0.4, size=(32, 64)).astype(np.float32)
    c = rng.integers(0, 32, size=n)
    X = centres[c] + rng.normal(0, 1.0, size=(n, 64)).astype(np.float32)
    table = LabelTable()
    for k in range(1, 9):
        table.to_index(f"c{k}")
    return X, (c % 8 + 1).astype(np.int32), table


def lvq_codes(X, lab, noc, seed=12):
    """An LVQ codebook of `noc` data rows drawn without replacement by
    default_rng(seed), carrying their classes."""
    from som_lvq_pak_torch.models.som import Dataset, Topology

    idx = np.random.default_rng(seed).choice(X.shape[0], noc, replace=False)
    return Dataset(points=X[idx], labels=lab[idx], topol=Topology.LVQ)


def lvq_e2e(make, fit_kw, X, lab, codes, table, chunk, mask=None, rlen=None,
            around=None):
    """One streamed fit of the trainer `make(codes)` for `rlen` samples (one
    lap by default), then accuracy(parity=False) over all of X (with its
    mask); a 2-batch warm-up fit and a 4096-row accuracy first.  Returns
    (accuracy_pct, train_s, accuracy_eval_s, trained codebook)."""
    import torch

    from som_lvq_pak_torch.models.eval import accuracy
    from som_lvq_pak_torch.models.som import Dataset

    n = X.shape[0]
    rlen = n if rlen is None else rlen

    def stream(total):
        return som_stream(X, chunk, total, mask=mask, labels=lab)

    data = Dataset(points=X, labels=lab, mask=mask)
    bs = make(codes).batch_size
    warm = make(codes).fit(stream(2 * bs), rlen=2 * bs, allow_short_stream=True,
                           **fit_kw)
    accuracy(Dataset(points=X[:4096], labels=lab[:4096],
                     mask=None if mask is None else mask[:4096]), warm,
             labels=table, device="cuda")
    torch.cuda.synchronize()

    around = around or (lambda part: contextlib.nullcontext())
    with around("train"):
        t0 = time.perf_counter()
        out = make(codes).fit(stream(rlen), rlen=rlen, **fit_kw)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    with around("eval"):
        t0 = time.perf_counter()
        pct = accuracy(data, out, labels=table, device="cuda")[0]
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    if not np.isfinite(out.points).all() or out.points.shape != codes.points.shape:
        raise AssertionError("trained codebook is not finite or has the wrong shape")
    return pct, train_s, eval_s, out


def check_accuracy(name, pct, pct_plain):
    if not (np.isfinite(pct) and abs(pct - pct_plain) <= 0.5):
        raise AssertionError(f"{name}: accuracy {pct} vs plain {pct_plain} (> 0.5 points)")


def olvq1_trainer(codes, mesh=None):
    from som_lvq_pak_torch.models.trainer import OLVQ1Trainer

    return OLVQ1Trainer(codes, batch_size=1024, alpha=0.3, mesh=mesh, device="cuda")


def lvq_trainer(algorithm):
    from som_lvq_pak_torch.models.trainer import LVQTrainer

    return lambda codes, mesh=None: LVQTrainer(codes, algorithm, winlen=0.3,
                                               epsilon=0.1, batch_size=1024,
                                               mesh=mesh, device="cuda")


def masked_lvq_e2e(X, lab, mask, codes, table, around=None):
    """Phase 13: OLVQ1Trainer, then LVQTrainer("lvq2") from its codebook,
    each one lap on the stream, each followed by the masked accuracy.
    Returns (olvq1 accuracy, lvq2 accuracy, train_s of both, eval_s of the
    last)."""
    pct_o, train_o, _, out = lvq_e2e(olvq1_trainer, {}, X, lab, codes, table, 16384,
                                     mask=mask, around=around)
    pct, train_s, eval_s, _ = lvq_e2e(lvq_trainer("lvq2"), dict(alpha=0.01), X, lab,
                                      out, table, 16384, mask=mask, around=around)
    return pct_o, pct, train_o + train_s, eval_s


def lvq_setup():
    """The LVQ cells' data: the 1M labelled vectors with their 65,536-code
    codebook, and the first 100k with every other 16384-row chunk masked
    (default_rng(13)) with a 4096-code codebook drawn from the clean rows."""
    X, lab, table = lvq_data()
    X1, lab1 = X[:100_000], lab[:100_000]
    Xm, mask, _ = masked_data(X1, 13, 16384, every_other=True)
    return (X, lab, table, lvq_codes(X, lab, 65536), Xm, lab1, mask,
            lvq_codes(X1, lab1, 4096))


@contextlib.contextmanager
def knn_recorded(rec):
    """Record, into `rec`, the self-kNN indices ("idx") and the correct mask
    ("correct") that models.lvq's eveninit computes (its chunked_topk and
    knn_correct_mask, called through the module)."""
    from som_lvq_pak_torch.models import lvq

    topk, correct = lvq.chunked_topk, lvq.knn_correct_mask

    def topk_spy(*a, **kw):
        out = topk(*a, **kw)
        rec["idx"] = out[0].cpu().numpy()
        return out

    def correct_spy(*a, **kw):
        rec["correct"] = correct(*a, **kw)
        return rec["correct"]

    lvq.chunked_topk, lvq.knn_correct_mask = topk_spy, correct_spy
    try:
        yield
    finally:
        lvq.chunked_topk, lvq.knn_correct_mask = topk, correct


def timed(walls, name, fn):
    """fn() with its wall (ended by a synchronise) in walls[name]."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
    return out


def lvq_knn_run(X, lab, table, noc=4096, knn=5):
    """Phase 13c: the lvqexample chain's kNN tools over the labelled rows X:
    eveninit(mode="fast") for `noc` codes (its self-kNN recorded), then
    knn_accuracy, setlabel and elimin (fast: K10 on the reversed codebook)
    and confusion_matrix(parity=False) (K1).  Returns (results, walls)."""
    from som_lvq_pak_torch.models import eval as ev
    from som_lvq_pak_torch.models import lvq, tools
    from som_lvq_pak_torch.models.som import Dataset

    data = Dataset(points=X, labels=lab)
    rec, walls = {}, {}
    with knn_recorded(rec):
        codes = timed(walls, "eveninit_s", lambda: lvq.eveninit(data, noc, knn=knn))
    knn_pct = timed(walls, "knn_accuracy_s",
                    lambda: ev.knn_accuracy(data, codes, knn=knn, labels=table)[0])
    relabelled = timed(walls, "setlabel_s", lambda: tools.setlabel(codes, data, knn=knn))
    kept = timed(walls, "elimin_s", lambda: tools.elimin(data, knn=knn))
    _, mat, ok = timed(walls, "cmatr_s",
                       lambda: ev.confusion_matrix(data, codes, labels=table))
    return dict(codes=codes, idx=rec["idx"], correct=rec["correct"], knn_pct=knn_pct,
                setlabel=relabelled.first_labels(), kept=kept.points,
                cmatr_pct=100.0 * float(ok.mean()), cmatr_total=int(mat.sum())), walls


def rows_of(where, points):
    """The row that each of `points` (rows copied from the data) came from,
    by `where`, the data's {row bytes: row}."""
    return np.array([where[p.tobytes()] for p in points], np.int64)


def near_tie_rows(name, X, idx, idx_plain, rel=1e-5):
    """Rows whose k-NN lists differ from the plain run's.  Each must be a
    near-tie: every column's two neighbours within `rel` of each other in
    float64 (neighbours reordered, or swapped at the k-th place)."""
    rows = np.nonzero((idx != idx_plain).any(axis=1))[0]
    if rows.size:
        x64 = X[rows].astype(np.float64)[:, None, :]
        da = ((x64 - X[idx[rows]].astype(np.float64)) ** 2).sum(-1)
        db = ((x64 - X[idx_plain[rows]].astype(np.float64)) ** 2).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        if gap.max() >= rel:
            raise AssertionError(f"{name}: {rows.size} rows' neighbours differ, "
                                 f"largest relative gap {gap.max():.3g} >= {rel}")
    return rows


def check_knn_tools(name, X, out, plain):
    """The kNN tools' gates against the plain run (phases 13c and 13e): the
    self-kNN lists ("idx") equal except at near-ties, on at most 0.1% of
    the rows; the correct masks ("correct") and elimin's kept rows ("kept")
    differ only at those rows; eveninit's picks ("codes") equal, or their
    first difference at a row whose correct flag differs; setlabel's labels
    ("setlabel") counted.  Returns the counts."""
    near = near_tie_rows(name, X, out["idx"], plain["idx"])
    if near.size > 0.001 * X.shape[0]:
        raise AssertionError(f"{name}: {near.size} near-tie rows, over 0.1%")
    flips = np.nonzero(out["correct"] != plain["correct"])[0]
    if not np.isin(flips, near).all():
        raise AssertionError(f"{name}: correct masks differ off the near-tie rows")
    where = {X[i].tobytes(): i for i in range(X.shape[0])}
    kept, kept_plain = rows_of(where, out["kept"]), rows_of(where, plain["kept"])
    if not np.isin(np.setxor1d(kept, kept_plain), near).all():
        raise AssertionError(f"{name}: elimin's kept rows differ off the near-tie rows")
    # the picks in pick order: the first pass walks the rows in order, so the
    # first place the two lists part is the first row decided apart, which
    # only a flipped correct flag can do
    a, b = rows_of(where, out["codes"].points), rows_of(where, plain["codes"].points)
    n = min(a.size, b.size)
    part = np.nonzero(a[:n] != b[:n])[0]
    first = None
    if part.size:
        first = min(a[part[0]], b[part[0]])
    elif a.size != b.size:
        first = (a if a.size > n else b)[n]
    if first is not None and first not in flips:
        raise AssertionError(f"{name}: eveninit's picks part at a row whose kNN vote "
                             "did not flip")
    if out["codes"].n != plain["codes"].n:
        raise AssertionError(f"{name}: the codebook is short")
    return dict(near_tie_rows=int(near.size), correct_flips=int(flips.size),
                elimin_kept=int(kept.size), elimin_kept_plain=int(kept_plain.size),
                eveninit_picks_differ=int(np.setxor1d(a, b).size),
                setlabel_labels_differ=int((out["setlabel"] != plain["setlabel"]).sum()))


def check_lvq_knn(X, out, plain):
    """Phase 13c's gates against the plain run: check_knn_tools', then both
    accuracies within 0.5 points and the confusion matrix over every row.
    Returns the counts."""
    counts = check_knn_tools("e2e lvq knn", X, out, plain)
    check_accuracy("e2e lvq knntest", out["knn_pct"], plain["knn_pct"])
    check_accuracy("e2e lvq cmatr", out["cmatr_pct"], plain["cmatr_pct"])
    if out["cmatr_total"] != X.shape[0]:
        raise AssertionError("e2e lvq knn: the confusion matrix is short")
    return counts


SCAN_STEPS = 10_000
MASKED_SCAN_STEPS = 2_500
# 13d holds each trained codebook and olvq1's rates to the plain run's row
# by row: the updates are the same torch expressions, so equal winners give
# equal bits, and a winner that differs at a near-tie moves another code;
# at most SCAN_ROWS_OFF of the rows may then differ by more than SCAN_ATOL
SCAN_ATOL = 1e-5
SCAN_ROWS_OFF = 0.01


def rows_off(name, a, b):
    """Rows of a and b (codebooks (noc, D) or rates (noc,)) more than
    SCAN_ATOL apart anywhere; fails past SCAN_ROWS_OFF of the rows.
    Returns the count and the largest difference."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d = d.reshape(d.shape[0], -1).max(axis=1)
    off = int((d > SCAN_ATOL).sum())
    if off > SCAN_ROWS_OFF * d.shape[0]:
        raise AssertionError(f"{name}: {off} of {d.shape[0]} rows differ from the plain "
                             f"run's by more than {SCAN_ATOL} (at most {d.max():.3g})")
    return dict(rows_off=off, max_abs=float(d.max()))


def lvq_scans_run(codes, data, masked, table):
    """Phase 13d: the per-sample scans from 13c's codebook, each with its
    accuracy(parity=False) over `data`: olvq1 for SCAN_STEPS (K1 at B 1),
    lvq3 from its codebook for SCAN_STEPS (K8), then lvq1 and lvq2 from 13c's
    codebook over the masked rows for MASKED_SCAN_STEPS (K4, K9).  Returns
    (results, walls)."""
    from som_lvq_pak_torch.models import lvq
    from som_lvq_pak_torch.models.eval import accuracy

    walls, out = {}, {}
    out["olvq1"], out["alphas"] = timed(walls, "olvq1_s", lambda: lvq.olvq1_train(
        codes, data, SCAN_STEPS, 0.3, return_alphas=True))
    out["lvq3"] = timed(walls, "lvq3_s", lambda: lvq.lvq3_train(
        out["olvq1"], data, SCAN_STEPS, 0.05, 0.3, 0.1))
    out["lvq1_masked"] = timed(walls, "lvq1_masked_s", lambda: lvq.lvq1_train(
        codes, masked, MASKED_SCAN_STEPS, 0.05))
    out["lvq2_masked"] = timed(walls, "lvq2_masked_s", lambda: lvq.lvq2_train(
        codes, masked, MASKED_SCAN_STEPS, 0.05, 0.3))
    pct = {k: accuracy(data, out[k], labels=table)[0]
           for k in ("olvq1", "lvq3", "lvq1_masked", "lvq2_masked")}
    return dict(out, pct=pct), walls


def lvq_tool_phases(smi, tally, X, lab, Xm, labm, mask, table):
    """Phases 13c and 13d: the kNN tools over the labelled rows X (`lab`,
    names in `table`), then the per-sample scans from 13c's codebook, the
    masked ones over the rows Xm (`labm`, `mask`); each through the kernels
    and the plain versions, `tally(launches)` taking each run's counts."""
    from som_lvq_pak_torch.models.som import Dataset
    from som_lvq_pak_torch.ops.distance import chunked_topk

    # ---- 13c: the kNN tools on 262,144 labelled rows (K10, K1) -------------
    t0 = time.perf_counter()
    chunked_topk.plain_launches = 0
    run = lambda: lvq_knn_run(X, lab, table)  # noqa: E731
    (knn_out, walls), (knn_plain, walls_plain), got = main_path(
        "e2e_lvq_knn_262144", run, ("dist_topk", "dist_argmin"), run)
    tally(got)
    gates = check_lvq_knn(X, knn_out, knn_plain)
    emit("e2e_lvq_knn_262144", card=smi, rows=X.shape[0], codes=knn_out["codes"].n, knn=5,
         knn_accuracy_pct=knn_out["knn_pct"], plain_knn_accuracy_pct=knn_plain["knn_pct"],
         cmatr_accuracy_pct=knn_out["cmatr_pct"],
         plain_cmatr_accuracy_pct=knn_plain["cmatr_pct"], **gates, walls=walls,
         plain_walls=walls_plain, plain_route_chunks=chunked_topk.plain_launches,
         launches=got, phase_s=time.perf_counter() - t0,
         gate="k-NN lists equal the plain run's except near-ties (<= 0.1% of rows); "
              "correct masks, elimin's rows and eveninit's picks differ only there; "
              "accuracies within 0.5 points")

    # ---- 13d: the per-sample LVQ scans from 13c's codebook (K1, K8, K4, K9) -
    t0 = time.perf_counter()
    data = Dataset(points=X, labels=lab)
    masked_rows = Dataset(points=Xm, labels=labm, mask=mask)
    run = lambda: lvq_scans_run(knn_out["codes"], data, masked_rows, table)  # noqa: E731
    (scans, walls), (scans_plain, walls_plain), got = main_path(
        "e2e_lvq_scans_4096", run,
        ("dist_argmin", "dist_top2", "dist_argmin_masked", "dist_top2_masked"), run)
    tally(got)
    for k, v in scans["pct"].items():
        check_accuracy(f"e2e lvq scans {k}", v, scans_plain["pct"][k])
    vs_plain = {k: rows_off(f"e2e lvq scans {k}",
                            *((scans[k], scans_plain[k]) if k == "alphas"
                              else (scans[k].points, scans_plain[k].points)))
                for k in ("olvq1", "alphas", "lvq3", "lvq1_masked", "lvq2_masked")}
    if not scans["pct"]["olvq1"] > knn_out["cmatr_pct"]:
        raise AssertionError(f"e2e lvq scans: olvq1 accuracy {scans['pct']['olvq1']} not "
                             f"above eveninit's {knn_out['cmatr_pct']}")
    again, walls_again = lvq_scans_run(knn_out["codes"], data, masked_rows, table)
    for k in ("olvq1", "alphas", "lvq3"):
        a, b = scans[k], again[k]
        a, b = (a, b) if k == "alphas" else (a.points, b.points)
        if not np.array_equal(a.view(np.int32), b.view(np.int32)):
            raise AssertionError(f"e2e lvq scans: a rerun of {k} is not bit-equal")
    steps = dict(olvq1=SCAN_STEPS, lvq3=SCAN_STEPS, lvq1_masked=MASKED_SCAN_STEPS,
                 lvq2_masked=MASKED_SCAN_STEPS)
    emit("e2e_lvq_scans_4096", card=smi, accuracy_pct=scans["pct"],
         plain_accuracy_pct=scans_plain["pct"], init_accuracy_pct=knn_out["cmatr_pct"],
         samples_per_s={k: steps[k] / walls[k + "_s"] for k in steps},
         plain_samples_per_s={k: steps[k] / walls_plain[k + "_s"] for k in steps},
         vs_plain=vs_plain, walls=walls, rerun_walls=walls_again, plain_walls=walls_plain,
         rerun_bit_equal=["olvq1", "alphas", "lvq3"], launches=got,
         phase_s=time.perf_counter() - t0,
         gate="accuracy over the 262,144 rows within 0.5 points of the plain run; "
              f"each codebook and olvq1's rates within {SCAN_ATOL} of the plain run's "
              f"on all but {SCAN_ROWS_OFF:.0%} of the rows; olvq1 above the eveninit "
              "codebook; olvq1 and lvq3 reruns bit-equal")


# ---- phase 13e: the CLI's -fast tools (som_lvq_pak_torch.cli) ----------------

# vsom -fast's runs: the 100,000-row lap at B 1024 (K1 prologue, K13), then
# the streamed pair (-buffer 16384, one chunk a refill) over two chunks
CLI_VSOM = ["-rlen", 100_000, "-alpha", 0.05, "-radius", 32, "-batch", 1024, "-rand", 7]
CLI_STREAM = ["-rlen", 32_768, "-alpha", 0.05, "-radius", 32, "-batch", 1024, "-rand", 7,
              "-buffer", 16_384]
# vfind's answers on stdin: 8 trials of a 16x16 hexa gaussian map over
# bench.py:prep_vfind's phases (VFIND_PHASES)
CLI_VFIND = ["8", "vfind.dat", "vfind.dat", "vfind.cod", "hexa", "gaussian", "16", "16",
             "2048", "0.05", "4", "2048", "0.02", "2"]


def require_engine():
    """The I/O phases' precondition: the native data-file engine
    (som_lvq_pak_torch.data.native_io, built from native/somvq_io.cpp) is
    loaded and in use, so no read, write or chunk parse quietly takes the
    Python path."""
    from som_lvq_pak_torch.data import io as pio
    from som_lvq_pak_torch.data import native_io

    if not native_io.available():
        raise AssertionError("the native data-file engine is not available (no g++?)")
    if not pio._use_native():
        raise AssertionError("the native data-file engine is turned off (SOMVQ_NATIVE=0)")


@contextlib.contextmanager
def io_timed(walls, swaps):
    """Sum, into walls[key], the host clock of each (obj, name, key) in
    `swaps` (a text read, write or chunk parse); walls["native"] stays True
    while each of those calls went through the native engine (one
    native_io call in its own thread, a chunk parse on a prefetch thread
    included)."""
    import threading

    from som_lvq_pak_torch.data import native_io

    engine = threading.local()
    lock = threading.Lock()  # the prefetch thread's parses update walls too
    walls.setdefault("native", True)
    for _, _, key in swaps:
        walls.setdefault(key, 0.0)

    def counted(fn):
        def run(*a, **kw):
            engine.calls = getattr(engine, "calls", 0) + 1
            return fn(*a, **kw)
        return run

    def clocked(fn, key):
        def run(*a, **kw):
            before = getattr(engine, "calls", 0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt, native = time.perf_counter() - t0, getattr(engine, "calls", 0) > before
                with lock:
                    walls[key] += dt
                    walls["native"] = walls["native"] and native
        return run

    swaps = swaps + [(native_io, name, None) for name in
                     ("read_data_native", "parse_text_native", "format_entries_native")]
    saved = [getattr(obj, name) for obj, name, _ in swaps]
    for (obj, name, key), fn in zip(swaps, saved):
        setattr(obj, name, counted(fn) if key is None else clocked(fn, key))
    try:
        yield
    finally:
        for (obj, name, _), fn in zip(swaps, saved):
            setattr(obj, name, fn)


def cli_io_timed(walls):
    """io_timed over the CLI's text reads (cli.common's read_data) into
    walls["read_s"], its writes (every write_data of the cli modules) into
    walls["write_s"], and a StreamingReader's chunk parses, which run on its
    prefetch thread beside the call and so are part of its wall, into
    walls["stream_parse_s"]."""
    from som_lvq_pak_torch.cli import cmds_lvq, cmds_som, common
    from som_lvq_pak_torch.data.streaming import StreamingReader

    return io_timed(walls, [(common, "read_data", "read_s"),
                            (StreamingReader, "_parse_chunk", "stream_parse_s"),
                            (common, "write_data", "write_s"),
                            (cmds_lvq, "write_data", "write_s"),
                            (cmds_som, "write_data", "write_s")])


@contextlib.contextmanager
def engine_off():
    """SOMVQ_NATIVE=0 inside the block: reads, writes and chunk parses take
    the Python parser and writer."""
    saved = os.environ.get("SOMVQ_NATIVE")
    os.environ["SOMVQ_NATIVE"] = "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["SOMVQ_NATIVE"]
        else:
            os.environ["SOMVQ_NATIVE"] = saved


def cli_tool(walls, key, *argv, stdin=None):
    """One tool through som_lvq_pak_torch.cli.main on the card, in the
    working directory; its wall (to a synchronise) split into the text
    read, the call (a stream's chunk parses included) and the write in
    walls[key], with walls[key]["native"].  Returns (stdout, stderr); a
    non-zero exit fails, as does a read, write or chunk parse that did not
    go through the native engine."""
    import io

    import torch

    from som_lvq_pak_torch.cli import main as cli_main

    argv = [str(a) for a in argv]
    w = walls.setdefault(key, {})
    out, err = io.StringIO(), io.StringIO()
    stdin_saved = sys.stdin
    sys.stdin = io.StringIO(stdin or "")
    t0 = time.perf_counter()
    try:
        with cli_io_timed(w), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli_main(argv, device="cuda")
        torch.cuda.synchronize()
    finally:
        sys.stdin = stdin_saved
    w["total_s"] = time.perf_counter() - t0
    w["call_s"] = w["total_s"] - w["read_s"] - w["write_s"]
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit {rc}: {err.getvalue()[-500:]}")
    if not w["native"]:
        raise AssertionError(f"cli {argv}: a text read, write or chunk parse took "
                             "the Python path")
    return out.getvalue(), err.getvalue()


def cli_chain(where, full=True):
    """Phase 13e's tools in the directory `where` (som.dat, lvq.dat,
    vfind.dat and r.cod there): the SOM chain (vsom -fast, qerror -fast and
    -qetype 1, the streamed vsom pair, vfind -fast) and the LVQ chain
    (eveninit, olvq1, lvq3, knntest, setlabel, elimin, each -fast).  With
    full=False (the plain run) the tools its gates read: vsom, vfind and
    the LVQ chain.  Returns (printed lines, eveninit's recorded self-kNN,
    walls)."""
    cwd = os.getcwd()
    os.chdir(where)
    walls, lines, rec = {}, {}, {}
    try:
        cli_tool(walls, "vsom", "vsom", "-fast", "-din", "som.dat", "-cin", "r.cod",
                 "-cout", "v.cod", *CLI_VSOM)
        if full:
            lines["qerror"] = cli_tool(walls, "qerror", "qerror", "-fast", "-din",
                                       "som.dat", "-cin", "v.cod")[0]
            lines["qerror2"] = cli_tool(walls, "qerror -qetype 1", "qerror", "-fast",
                                        "-qetype", 1, "-din", "som.dat", "-cin", "v.cod")[0]
            cli_tool(walls, "vsom -bf16stream", "vsom", "-fast", "-bf16stream", "-din",
                     "som.dat", "-cin", "r.cod", "-cout", "s16.cod", *CLI_STREAM)
            cli_tool(walls, "vsom -buffer", "vsom", "-fast", "-din", "som.dat", "-cin",
                     "r.cod", "-cout", "s32.cod", *CLI_STREAM)
        lines["vfind"] = cli_tool(walls, "vfind", "vfind", "-fast",
                                  stdin="\n".join(CLI_VFIND) + "\n")
        with knn_recorded(rec):
            cli_tool(walls, "eveninit", "eveninit", "-fast", "-din", "lvq.dat", "-cout",
                     "e.cod", "-noc", 4096, "-knn", 5)
        cli_tool(walls, "olvq1", "olvq1", "-fast", "-din", "lvq.dat", "-cin", "e.cod",
                 "-cout", "o.cod", "-rlen", 65_536, "-batch", 1024)
        cli_tool(walls, "lvq3", "lvq3", "-fast", "-din", "lvq.dat", "-cin", "o.cod",
                 "-cout", "l3.cod", "-rlen", 65_536, "-alpha", 0.03, "-win", 0.3,
                 "-epsilon", 0.1)
        lines["knntest"] = cli_tool(walls, "knntest", "knntest", "-fast", "-din", "lvq.dat",
                                    "-cin", "l3.cod")[0]
        cli_tool(walls, "setlabel", "setlabel", "-fast", "-din", "lvq.dat", "-cin", "l3.cod",
                 "-cout", "sl.cod")
        cli_tool(walls, "elimin", "elimin", "-fast", "-din", "lvq.dat", "-cout", "el.cod")
    finally:
        os.chdir(cwd)
    return lines, rec, walls


def cli_twins(where, lines):
    """Each -fast tool's call through the port's Python API on the card,
    with the same inputs (read from the same files), arguments and seed;
    fails unless every output file equals the twin's write_data text and
    every printed line the twin's.  Returns the twins' walls and their
    text-read data (the SOM rows, the LVQ Dataset)."""
    import io

    from som_lvq_pak_torch.data.io import read_data, write_data
    from som_lvq_pak_torch.data.streaming import StreamingReader
    from som_lvq_pak_torch.models import eval as ev
    from som_lvq_pak_torch.models import lvq, som, tools
    from som_lvq_pak_torch.models.trainer import LVQTrainer, OLVQ1Trainer, SOMTrainer
    from som_lvq_pak_torch.utils.rng import CRandom

    def text(ds):
        buf = io.StringIO()
        write_data(ds, None, fileobj=buf)
        return buf.getvalue()

    def path(name):
        return os.path.join(where, name)

    def same(name, ds):
        with open(path(name)) as f:
            written = f.read()
        if written != text(ds):
            raise AssertionError(f"e2e cli: {name} differs from its API twin's")

    rng = CRandom()
    rng.init_random(7)
    seed = rng.state % (1 << 31)
    rlen, stream_rlen = (argv[argv.index("-rlen") + 1] for argv in (CLI_VSOM, CLI_STREAM))
    walls = {}
    som_data, r_cod = read_data(path("som.dat")), read_data(path("r.cod"))
    same("v.cod", timed(walls, "vsom", lambda: SOMTrainer(
        r_cod, batch_size=1024, device="cuda", seed=seed).fit(som_data, rlen, 0.05, 32.0)))
    v_cod = read_data(path("v.cod"))
    n = np.float32(som_data.n)
    q = timed(walls, "qerror", lambda: som.find_qerror(v_cod, som_data, device="cuda"))
    q2 = timed(walls, "qerror -qetype 1", lambda: som.find_qerror2(v_cod, som_data, 1.0,
                                                                 device="cuda"))
    for key, total in (("qerror", q), ("qerror2", q2)):
        want = ("Quantization error of som.dat with map v.cod is %f per sample (%d samples)\n"
                % (np.float32(total) / n, som_data.n))
        if lines[key] != want:
            raise AssertionError(f"e2e cli: {key} printed {lines[key]!r}, the API {want!r}")
    for name, bf16 in (("s16.cod", True), ("s32.cod", False)):
        same(name, timed(walls, "vsom -bf16stream" if bf16 else "vsom -buffer", lambda: SOMTrainer(
            r_cod, batch_size=1024, device="cuda", seed=seed, stream_bf16=bf16).fit(
                StreamingReader(path("som.dat"), 16_384).chunks(laps=None), stream_rlen, 0.05,
                32.0)))
    vdata = read_data(path("vfind.dat"))
    best = timed(walls, "vfind", lambda: som.vfind_trials(
        vdata, vdata, 8, som.Topology.HEXA, som.Neighborhood.GAUSSIAN, 16, 16,
        VFIND_PHASES, device="cuda")[0])
    same("vfind.cod", best)
    ldata = read_data(path("lvq.dat"))
    same("e.cod", timed(walls, "eveninit", lambda: lvq.eveninit(ldata, 4096, knn=5,
                                                                device="cuda")))
    same("o.cod", timed(walls, "olvq1", lambda: OLVQ1Trainer(
        read_data(path("e.cod")), batch_size=1024, alpha=0.3, device="cuda").fit(
            ldata, 65_536)))
    l3 = timed(walls, "lvq3", lambda: LVQTrainer(
        read_data(path("o.cod")), algorithm="lvq3", batch_size=1024, winlen=0.3,
        epsilon=0.1, device="cuda").fit(ldata, 65_536, 0.03))
    same("l3.cod", l3)
    l3 = read_data(path("l3.cod"))
    report = timed(walls, "knntest", lambda: ev.knn_accuracy(ldata, l3, knn=5,
                                                             device="cuda")[1])
    if lines["knntest"] != report:
        raise AssertionError("e2e cli: knntest's report differs from the API's")
    same("sl.cod", timed(walls, "setlabel", lambda: tools.setlabel(l3, ldata, knn=5,
                                                                   device="cuda")))
    same("el.cod", timed(walls, "elimin", lambda: tools.elimin(ldata, knn=5, device="cuda")))
    return walls, som_data, ldata


def vfind_trials_printed(err):
    """vfind's per-trial qerrors from its stderr ("%3d: %f")."""
    return {int(a): float(b) for a, b in
            (ln.split(":") for ln in err.splitlines() if ln.strip()[:1].isdigit())}


def fresh_qerror(where, line):
    """Part 2 of phase 13e: `python -m som_lvq_pak_torch.cli qerror -fast`
    in a process of its own, which must exit 0 and print `line`; beside its
    wall, that of a bare interpreter and of one that imports torch and
    loads the built library (each a process of its own)."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    probe = ("import json, time; t0 = time.perf_counter(); import torch; "
             "t1 = time.perf_counter(); torch.cuda.init(); t2 = time.perf_counter(); "
             "from som_lvq_pak_torch import _build; _build.library(); "
             "t3 = time.perf_counter(); print(json.dumps(dict(torch_import_s=t1 - t0, "
             "cuda_init_s=t2 - t1, library_load_s=t3 - t2)))")
    walls = {}
    for key, argv in (("bare_python_s", ["-c", "pass"]), ("probe_s", ["-c", probe]),
                      ("qerror_s", ["-m", "som_lvq_pak_torch.cli", "qerror", "-fast",
                                    "-din", "som.dat", "-cin", "v.cod"])):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, *argv], cwd=where, env=env,
                             capture_output=True, text=True, timeout=300)
        walls[key] = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"e2e cli fresh process {argv[:3]}: exit "
                                 f"{out.returncode}: {out.stderr[-500:]}")
        if key == "probe_s":
            walls.update(json.loads(out.stdout))
        if key == "qerror_s" and out.stdout != line:
            raise AssertionError(f"e2e cli fresh process printed {out.stdout!r}, "
                                 f"in-process {line!r}")
    return walls


def sammon_error64(dmat, x, y, rows=2048):
    """Sammon's mapping error of the layout (x, y) against the distances
    `dmat` (noc, noc), in float64 on the card: the sum over pairs j < k of
    (d - dp)^2 / d over the sum of d, taken in row blocks."""
    import torch

    x, y = x.double(), y.double()
    noc = x.shape[0]
    num = torch.zeros((), dtype=torch.float64, device=x.device)
    den = torch.zeros_like(num)
    cols = torch.arange(noc, device=x.device)
    for lo in range(0, noc, rows):
        hi = min(noc, lo + rows)
        d = dmat[lo:hi].double()
        dp = torch.sqrt((x[lo:hi, None] - x[None, :]) ** 2 + (y[lo:hi, None] - y[None, :]) ** 2)
        upper = cols[None, :] > torch.arange(lo, hi, device=x.device)[:, None]
        num += torch.where(upper, (d - dp) ** 2 / torch.where(upper, d, 1.0), 0.0).sum()
        den += torch.where(upper, d, 0.0).sum()
    return float(num / den)


SAMMON_STEPS = (20, 100)


def sammon_phase(smi, v_path):
    """sammon_fast on the card on 13e's trained 128x128 codebook (16,384
    units): SAMMON_STEPS[-1] iterations (the layout's error also read at
    SAMMON_STEPS[0]); gates: finite, a rerun bit-equal, the mapping error
    (float64 on the card) below the initial layout's."""
    import torch

    from som_lvq_pak_torch.data.io import read_data
    from som_lvq_pak_torch.models import sammon
    from som_lvq_pak_torch.utils.rng import CRandom

    t_phase = time.perf_counter()
    codes = read_data(v_path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for steps in SAMMON_STEPS + SAMMON_STEPS[-1:]:
        t0 = time.perf_counter()
        proj, deduped = sammon.sammon_fast(codes, steps, seed=1, device="cuda")
        torch.cuda.synchronize()
        runs.setdefault(steps, []).append((proj, time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    proj, wall = runs[SAMMON_STEPS[-1]][0]
    again = runs[SAMMON_STEPS[-1]][1][0]
    if not np.isfinite(proj.points).all() or proj.points.shape != (deduped.n, 2):
        raise AssertionError("sammon_fast: the layout is not finite or of the wrong shape")
    if not np.array_equal(proj.points.view(np.int32), again.points.view(np.int32)):
        raise AssertionError("sammon_fast: a rerun on the card is not bit-equal")
    P = torch.from_numpy(deduped.points).to("cuda")
    dmat = sammon._pairwise_dist_euc_t(P, None)
    rng = CRandom()
    rng.init_random(1)
    x0, y0 = (torch.from_numpy(a).to("cuda") for a in sammon.initial_layout(deduped.n, rng))
    err0 = sammon_error64(dmat, x0, y0)
    errs = {steps: sammon_error64(dmat, *(torch.from_numpy(np.ascontiguousarray(
        runs[steps][0][0].points[:, i])).to("cuda") for i in (0, 1))) for steps in SAMMON_STEPS}
    if not errs[SAMMON_STEPS[-1]] < err0:
        raise AssertionError(f"sammon_fast: mapping error {errs[SAMMON_STEPS[-1]]} not "
                             f"below the initial layout's {err0}")
    del P, dmat
    emit("e2e_sammon_fast_128x128", card=smi, units=codes.n, kept=deduped.n,
         steps=SAMMON_STEPS[-1], mapping_error=errs, initial_mapping_error=err0,
         walls={steps: [w for _, w in runs[steps]] for steps in runs},
         peak_allocated_gib=peak, rerun_bit_equal=True, phase_s=time.perf_counter() - t_phase,
         gate=f"finite; a rerun bit-equal; the mapping error after {SAMMON_STEPS[-1]} "
              "iterations (float64 on the card) below the initial layout's")


def cli_phase(smi, tally, X_som, X_lvq, lab_lvq, table):
    """Phase 13e: the CLI's -fast tools on the card, in a temporary
    directory: the SOM chain on `X_som` (100,000 x 64, written by the port's
    write_data), vfind on 2048 x 16 rows, the LVQ chain on `X_lvq` with
    labels `lab_lvq` (names in `table`); then the same tools' API twins, the
    gates against the plain run, one fresh-process qerror, and sammon_fast
    on the trained map.  `tally(launches)` takes the main run's counts."""
    import shutil
    import tempfile

    import torch

    from som_lvq_pak_torch.data.io import read_data, write_data
    from som_lvq_pak_torch.models import eval as ev
    from som_lvq_pak_torch.models import som
    from som_lvq_pak_torch.models.som import Dataset

    require_engine()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {k: os.path.join(tmp, k) for k in ("cuda", "plain")}
        t0 = time.perf_counter()
        for d in dirs.values():
            os.makedirs(d)
        base = dirs["cuda"]
        write_data(Dataset(points=X_som), os.path.join(base, "som.dat"))
        write_data(Dataset(points=X_lvq, labels=lab_lvq), os.path.join(base, "lvq.dat"),
                   labels=table)
        write_data(Dataset(points=np.random.default_rng(9).normal(
            0, 1, size=(2048, 16)).astype(np.float32)), os.path.join(base, "vfind.dat"))
        cwd = os.getcwd()
        os.chdir(base)
        setup = {}
        try:
            cli_tool(setup, "randinit", "randinit", "-din", "som.dat", "-cout", "r.cod", "-xdim", 128,
                     "-ydim", 128, "-topol", "hexa", "-neigh", "gaussian", "-rand", 123)
        finally:
            os.chdir(cwd)
        for name in ("som.dat", "lvq.dat", "vfind.dat", "r.cod"):
            shutil.copy(os.path.join(base, name), dirs["plain"])
        setup_s = time.perf_counter() - t0

        (lines, rec, walls), (plain_lines, plain_rec, plain_walls), got = main_path(
            "e2e_cli_fast", lambda: cli_chain(base),
            ("dist_argmin", "dist_argmin_t", "som_fused_factored_step",
             "som_neighborhood_update_idx", "dist_top2", "dist_topk", "segment_sum"),
            lambda: cli_chain(dirs["plain"], full=False))
        tally(got)
        chain_s = time.perf_counter() - t_phase

        twin_walls, som_data, ldata = cli_twins(base, lines)

        def codes(where, name):
            return read_data(os.path.join(where, name))

        # the gates against the plain run
        n = som_data.n
        q = {k: som.find_qerror(codes(dirs[k], "v.cod"), som_data, device="cuda") / n
             for k in dirs}
        check_e2e("e2e cli vsom", q["cuda"], q["plain"])
        q16, q32 = (som.find_qerror(codes(base, name), som_data, device="cuda") / n
                    for name in ("s16.cod", "s32.cod"))
        check_e2e("e2e cli vsom -bf16stream", q16, q32)
        trials, plain_trials = (vfind_trials_printed(x["vfind"][1])
                                for x in (lines, plain_lines))
        best = lambda x: int(x["vfind"][0].split("random seed")[1].split(":")[0])  # noqa: E731
        ranked = sorted(plain_trials.values())
        if best(lines) != best(plain_lines) and ranked[1] - ranked[0] > 0.01 * ranked[0]:
            raise AssertionError(f"e2e cli vfind: best trial {best(lines)}, plain "
                                 f"{best(plain_lines)}")
        pct = {}
        for name in ("o.cod", "l3.cod"):
            pct[name] = {k: ev.accuracy(ldata, codes(dirs[k], name), device="cuda")[0]
                         for k in dirs}
            check_accuracy(f"e2e cli {name}", pct[name]["cuda"], pct[name]["plain"])
        knn_pct = {k: float((lines if k == "cuda" else plain_lines)["knntest"]
                            .strip().splitlines()[-1].split()[-2]) for k in dirs}
        check_accuracy("e2e cli knntest", knn_pct["cuda"], knn_pct["plain"])
        X = ldata.points
        knn = {k: dict(idx=r["idx"], correct=r["correct"], codes=codes(dirs[k], "e.cod"),
                       kept=codes(dirs[k], "el.cod").points,
                       setlabel=codes(dirs[k], "sl.cod").first_labels())
               for k, r in (("cuda", rec), ("plain", plain_rec))}
        counts = check_knn_tools("e2e cli knn", X, knn["cuda"], knn["plain"])
        # the SOM text file read once more with the engine on, then with it
        # off (SOMVQ_NATIVE=0: the Python parser): the same arrays
        engine_vs_python = {}
        som_path = os.path.join(base, "som.dat")
        on = timed(engine_vs_python, "engine_read_s", lambda: read_data(som_path))
        with engine_off():
            off = timed(engine_vs_python, "python_read_s", lambda: read_data(som_path))
        if not np.array_equal(on.points.view(np.int32), off.points.view(np.int32)):
            raise AssertionError("e2e cli: the engine's read of som.dat is not the "
                                 "Python parser's")
        fresh = fresh_qerror(base, lines["qerror"])
        phase_s = time.perf_counter() - t_phase
        emit("e2e_cli_fast", card=smi, qerror_line=lines["qerror"].strip(),
             qerror2_line=lines["qerror2"].strip(), qerror_per_sample=q,
             bf16stream_qerror_per_sample=q16, f32stream_qerror_per_sample=q32,
             vfind_best_trial=best(lines), plain_vfind_best_trial=best(plain_lines),
             vfind_qerror_per_sample=trials, plain_vfind_qerror_per_sample=plain_trials,
             accuracy_pct=pct, knntest_accuracy_pct=knn_pct, **counts, walls=walls,
             api_walls=twin_walls, plain_walls=plain_walls,
             som_dat_read_engine_vs_python=engine_vs_python, setup_s=setup_s,
             setup_walls=setup, chain_s=chain_s, fresh_process=fresh, launches=got,
             phase_s=phase_s,
             gate="every -fast output byte-equal to its API twin and every printed line "
                  "the API's; vsom's qerror within 1% of the plain run and the bf16 "
                  "stream within 1% of the float32 stream; vfind's best trial the plain "
                  "run's unless its two best are within 1%; olvq1, lvq3 and knntest "
                  "within 0.5 points; eveninit, setlabel and elimin apart only at "
                  "near-ties (13c's rule); the fresh-process qerror line equal")
        sammon_phase(smi, os.path.join(base, "v.cod"))
        del som_data, ldata, X
        torch.cuda.empty_cache()


# ---- phases 13f, 13g: the port's examples (som_lvq_pak_torch.examples) -------

# the JAX examples' defaults (examples/large_som.py, examples/streaming_som.py)
LARGE_SOM = dict(n=100_000, dim=64, side=128, batch=1024, rlen=0, sammon_sub=512)
STREAM_SOM = dict(n=1_000_000, dim=64, side=128, batch=1024, buffer=16_384, laps=1)
STREAM_ON_OFF_ROWS = 262_144  # the engine-on/off streamed pair
TRACE_STEPS = 16  # the fit under utils.progress.trace

# the fused-step kernel fused_step_choice picks: its launch counter and its
# CUDA function's name (as a trace shows it)
# (launch counter, CUDA function up to D 128, past it); K3 and K13 run their
# Hopper walk up to D 128 (ops.som_step.k3_route, k13_route)
FUSED_STEP_KERNELS = {
    "K13": ("som_fused_factored_step", "som_fused_factored_sm90_kernel",
            "som_fused_factored_kernel"),
    "K14": ("som_fused_factored_chunked_step", "som_chunked_sm90_kernel",
            "som_fused_factored_chunked_tc_kernel"),
    "K3": ("som_fused_train_step", "som_fused_step_sm90_kernel", "som_fused_step_kernel")}


def fused_step_kernel(side, batch, dim):
    """The fused-step kernel SOMTrainer takes for a side x side hexa gaussian
    map at this batch and width (models.trainer.fused_step_choice, the JAX
    trainer's rule): (K name, launch counter, CUDA function)."""
    from som_lvq_pak_torch.models.trainer import fused_step_choice
    from som_lvq_pak_torch.ops.som_step import SM90_MAX_D

    factored, _, chunk, _, _ = fused_step_choice(side * side, side, True, True, batch, dim)
    k = "K14" if chunk else "K13" if factored else "K3"
    counter, walk, wide = FUSED_STEP_KERNELS[k]
    return k, counter, walk if dim <= SM90_MAX_D else wide


def example_large_som_phase(smi, tally):
    """Phase 13f: som_lvq_pak_torch.examples.large_som.run_large_som at the
    JAX example's defaults on the card (the fused step fused_step_choice
    picks, K1 prologue, K2 qerror, sammon_fast), then through the plain
    versions on the card; gates: check_summary, each qerror point within 1%
    of the plain run's (check_e2e's rule)."""
    from som_lvq_pak_torch.examples import large_som

    require_engine()
    t_phase = time.perf_counter()
    k, counter, _ = fused_step_kernel(LARGE_SOM["side"], LARGE_SOM["batch"], LARGE_SOM["dim"])
    walls = {}

    def run(key):
        return timed(walls, key, lambda: large_som.run_large_som(**LARGE_SOM, device="cuda"))

    s, s_plain, got = main_path("e2e_example_large_som", lambda: run("run_s"),
                                ("dist_argmin", "dist_argmin_t", counter),
                                lambda: run("plain_run_s"))
    tally(got)
    large_som.check_summary(s)
    for i, (q, q_plain) in enumerate(zip(s["qerror_curve"], s_plain["qerror_curve"])):
        check_e2e(f"e2e example large_som qerror point {i}", q, q_plain)
    emit("e2e_example_large_som", card=smi, args=LARGE_SOM, summary=s,
         plain_summary=s_plain, fused_step_kernel=k, fused_step_launches=got[counter],
         walls=walls, launches=got, phase_s=time.perf_counter() - t_phase,
         gate="check_summary; each qerror point within 1% of the plain run's")


def stream_fit(path, codes, rlen, walls):
    """examples.streaming_som.fit_stream on the card (B 1024, 16,384-row
    chunks) over `rlen` samples of `path`, its wall in walls["train_s"] and
    its chunk parses in walls["stream_parse_s"] with walls["native"]
    (io_timed); returns the trained codebook."""
    from som_lvq_pak_torch.data.streaming import StreamingReader
    from som_lvq_pak_torch.examples.streaming_som import fit_stream
    from som_lvq_pak_torch.models.trainer import SOMTrainer

    tr = SOMTrainer(codes, batch_size=STREAM_SOM["batch"], device="cuda")
    with io_timed(walls, [(StreamingReader, "_parse_chunk", "stream_parse_s")]):
        return timed(walls, "train_s",
                     lambda: fit_stream(tr, path, rlen, STREAM_SOM["buffer"]))


def example_streaming_som_phase(smi, tally):
    """Phase 13g: som_lvq_pak_torch.examples.streaming_som on a 1M x 64 file
    that its generate_file writes into a temporary directory (outside the
    timed fit): run_streaming_som on the card, then through the plain
    versions on the card (the engine parses the chunks in both); gates: the
    held-out qerror falls and is within 1% of the plain run's, and every
    chunk parse went through the engine.  Then a streamed fit of 262,144
    rows with the engine on and with SOMVQ_NATIVE=0: the codebooks bit-equal
    (the parses give the same floats, reruns on the card are bit-equal).
    Then where a 1M-row lap's time goes: the reader alone over the file,
    and the fit under torch.profiler (a "profile" line: device busy time
    and idle share).  Then a 16-step fit under utils.progress.trace: the
    exported trace must name the fused-step kernel."""
    import glob
    import tempfile

    import torch

    from som_lvq_pak_torch.data.streaming import StreamingReader
    from som_lvq_pak_torch.examples import streaming_som
    from som_lvq_pak_torch.utils.progress import trace

    require_engine()
    t_phase = time.perf_counter()
    k, counter, kernel_fn = fused_step_kernel(STREAM_SOM["side"], STREAM_SOM["batch"],
                                              STREAM_SOM["dim"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"stream_som_{STREAM_SOM['n']}x{STREAM_SOM['dim']}.dat")
        gen_s = streaming_som.generate_file(path, STREAM_SOM["n"], STREAM_SOM["dim"])
        walls = {key: {} for key in ("cuda", "plain")}

        def run(key):
            with io_timed(walls[key], [(StreamingReader, "_parse_chunk", "stream_parse_s")]):
                return timed(walls[key], "run_s", lambda: streaming_som.run_streaming_som(
                    path, **STREAM_SOM, device="cuda"))

        s, s_plain, got = main_path("e2e_example_streaming_som", lambda: run("cuda"),
                                    ("dist_argmin", "dist_argmin_t", counter),
                                    lambda: run("plain"))
        tally(got)
        (q0, q1), (_, q1_plain) = s["qerror_subsample"], s_plain["qerror_subsample"]
        if not q1 < q0:
            raise AssertionError(f"e2e example streaming_som: qerror {q0} -> {q1} did not fall")
        check_e2e("e2e example streaming_som held-out qerror", q1, q1_plain)
        if not (walls["cuda"]["native"] and walls["plain"]["native"]):
            raise AssertionError("e2e example streaming_som: a chunk parse took the "
                                 "Python path")

        # the engine on and off under one streamed fit: the same codebook
        _, codes0 = streaming_som.head_codebook(path, STREAM_SOM["side"], STREAM_SOM["buffer"])
        pair, out = {"engine": {}, "python": {}}, {}
        out["engine"] = stream_fit(path, codes0, STREAM_ON_OFF_ROWS, pair["engine"])
        with engine_off():
            out["python"] = stream_fit(path, codes0, STREAM_ON_OFF_ROWS, pair["python"])
        if not pair["engine"]["native"] or pair["python"]["native"]:
            raise AssertionError(f"e2e example streaming_som: engine on/off not as set: {pair}")
        if not np.array_equal(out["engine"].points.view(np.int32),
                              out["python"].points.view(np.int32)):
            raise AssertionError("e2e example streaming_som: the engine-on and engine-off "
                                 "fits' codebooks are not bit-equal")

        # where a streamed lap's time goes: the reader alone (its line loop
        # and parses, no card), then the example's fit under torch.profiler
        # (the device's busy time and idle share)
        lap = {"reader": {}, "fit": {}}
        with io_timed(lap["reader"], [(StreamingReader, "_parse_chunk", "stream_parse_s")]):
            lap["reader"]["rows"] = timed(lap["reader"], "lap_s", lambda: sum(
                c.n for c in StreamingReader(path, STREAM_SOM["buffer"]).chunks(laps=1)))
        with profiled("e2e_example_streaming_som train"):
            stream_fit(path, codes0, STREAM_SOM["n"], lap["fit"])

        # a short fit under utils.progress.trace: the trace names the kernel
        logdir = os.path.join(tmp, "trace")
        with trace(logdir):
            stream_fit(path, codes0, TRACE_STEPS * STREAM_SOM["batch"], {})
            torch.cuda.synchronize()
        (trace_file,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        with open(trace_file) as f:
            events = json.load(f)["traceEvents"]
        named = sum(1 for e in events
                    if e.get("cat") == "kernel" and kernel_fn in e.get("name", ""))
        if named == 0:
            raise AssertionError(f"e2e example streaming_som: the trace names no "
                                 f"{kernel_fn} launch")
        trace_mb = os.path.getsize(trace_file) / 1e6
    emit("e2e_example_streaming_som", card=smi, args=STREAM_SOM, summary=s,
         plain_summary=s_plain, generate_file_s=gen_s, fused_step_kernel=k,
         fused_step_launches=got[counter], walls=walls, launches=got,
         engine_on_off_rows=STREAM_ON_OFF_ROWS, engine_on_off_walls=pair,
         engine_on_off_bit_equal=True, streamed_lap=lap, trace_steps=TRACE_STEPS,
         trace_kernel_events=named, trace_kernel=kernel_fn, trace_mb=trace_mb,
         phase_s=time.perf_counter() - t_phase,
         gate="held-out qerror falls and within 1% of the plain run's; every chunk "
              "parse on the engine; engine-on and engine-off codebooks bit-equal; the "
              "trace names the fused-step kernel")


@contextlib.contextmanager
def profiled(label: str):
    """torch.profiler around a block that ends synchronised; emits its wall,
    the device's busy time (the union of kernel and copy intervals), the
    idle share, the five kernels with the most device time, and the port's
    launches in the block by its wrappers' counters (the trace has dropped
    device records after a long traced block: a kernel the counters show
    and the top list lacks is such a loss, and the busy time is then low)."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = {fn.__name__: fn.launches for fn in counted()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        wall = time.perf_counter() - t0
    launched = {fn.__name__: fn.launches - before[fn.__name__] for fn in counted()}
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of the device intervals, in microseconds
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name)
            name = name.split("(")[0]
            tot, cnt = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + e.time_range.end - e.time_range.start, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    emit("profile", cell=label, wall_s=wall, device_busy_s=busy * 1e-6,
         idle_share=1.0 - busy * 1e-6 / wall if wall > 0 else None,
         top=[dict(kernel=k, device_s=t * 1e-6, launches=c) for k, (t, c) in top],
         port_launches={k: n for k, n in launched.items() if n})


def profile_cells() -> None:
    """Every e2e cell of the main run once, its training and its evaluation
    under torch.profiler (profiled walls run slower than plain ones)."""
    X = blob_data(42, 100_000, 4)
    Xm128, mask128, rng = masked_data(X, 43, 8192, every_other=True)
    w128 = rng.uniform(0.5, 2.0, size=X.shape[0]).astype(np.float32)
    Xm64, mask64, rng = masked_data(X, 43, 16384, every_other=True)
    w64 = rng.uniform(0.5, 2.0, size=X.shape[0]).astype(np.float32)
    cells = [("e2e_128x128_100k", (X, 128, 1024, 32, 8192), {}),
             ("e2e_masked_128x128_100k", (Xm128, 128, 1024, 32, 8192),
              dict(mask=mask128, weight=w128)),
             ("e2e_masked_64x64_100k", (Xm64, 64, 512, 16, 16384),
              dict(mask=mask64, weight=w64))]
    for name, args, kw in cells:
        e2e(*args, **kw, around=lambda part: profiled(f"{name} {part}"))
    som_batch_steps(X, 128, 1024, 8)  # phase 5's steps (K1 + K5): a warm-up
    with profiled("som_batch_step_128x128 train"):
        som_batch_steps(X, 128, 1024, 8)
    X = blob_data(7, 1_000_000, 16)
    Xm, mask, _ = masked_data(X, 8, 16384, every_other=False)
    cells = [("e2e_256x256_1M", (X, 256, 4096, 64, 16384), {}),
             ("e2e_64x64_1M", (X, 64, 512, 16, 16384), {}),
             ("e2e_64x64_1M_stepwise", (X, 64, 512, 16, 16384), dict(vmem_steps=False)),
             ("e2e_64x64_1M_B4096", (X, 64, 4096, 16, 16384), {}),
             ("e2e_masked_256x256_1M", (Xm, 256, 4096, 64, 16384), dict(mask=mask))]
    for name, args, kw in cells:
        e2e(*args, **kw, around=lambda part: profiled(f"{name} {part}"))
    del X, Xm, mask
    X, lab, table, codes, Xm, lab1, mask, small = lvq_setup()
    _, _, _, trained = lvq_e2e(olvq1_trainer, {}, X, lab, codes, table, 16384,
                               around=lambda part: profiled(f"e2e_olvq1_65536_1M {part}"))
    lvq_e2e(lvq_trainer("lvq3"), dict(alpha=0.01), X, lab, trained, table, 16384,
            rlen=262_144, around=lambda part: profiled(f"e2e_lvq3_65536_1M {part}"))
    masked_lvq_e2e(Xm, lab1, mask, small, table,
                   around=lambda part: profiled(f"e2e_masked_lvq_4096_100k {part}"))


# ---- the mesh phases: worker functions run by every rank of a world ----------
# (parallel.mesh.spawn starts each rank with the "spawn" method, which loads
# this file as its main module; nothing here imports jax)

MESH_TIMEOUT_S = 300.0


def rank_fit(mesh, fit):
    """On every rank: the launch counters set to 0, a barrier, `fit()` (a
    trainer's fit, or a step returning (codes, winners)), a synchronize;
    returns (its result, the rank's record: train_s, launches, the whole
    codebook (and winners), backend and layout)."""
    import torch
    import torch.distributed as dist

    for fn in counted():
        fn.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    out = fit()
    torch.cuda.synchronize()
    rec = dict(train_s=time.perf_counter() - t0,
               launches={fn.__name__: fn.launches for fn in counted()},
               backend=mesh.backend, layout=mesh.shape)
    if isinstance(out, tuple):
        rec.update(codes=out[0].cpu().numpy(), winners=out[1].cpu().numpy())
    else:
        rec["codes"] = out.points
    dist.barrier()
    return out, rec


def mesh_som(mesh, X, map_dim, bs, radius, chunk=None, mask=None, weight=None):
    """SOMTrainer(mesh=) for one lap of X from the random-init map: a
    Dataset (the fused steps), or with `chunk` a stream (the two-pass
    step)."""
    from som_lvq_pak_torch.models.som import Dataset
    from som_lvq_pak_torch.models.trainer import SOMTrainer

    codes = random_codes(X, map_dim, mask)
    n = X.shape[0]
    data = (Dataset(points=X) if chunk is None
            else som_stream(X, chunk, n, mask=mask, weight=weight))
    return rank_fit(mesh, lambda: SOMTrainer(codes, batch_size=bs, mesh=mesh,
                                             device="cuda").fit(
        data, rlen=n, alpha=0.05, radius=radius, allow_short_stream=True,
        use_weights=weight is not None))[1]


def mesh_tp_world(mesh):
    """Phase 14 on each rank of the (data 1, model 2) world."""
    return {"tp": mesh_som(mesh, blob_data(7, 1_000_000, 16), 256, 4096, 64)}


def step_inputs(seed=37, noc=65536, B=4096, D=64):
    """One step's inputs on a 256x256 map: codes, a batch, its BMUs and the
    next batch (default_rng(seed))."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return f(noc, D), f(B, D), rng.integers(0, noc, size=B).astype(np.int32), f(B, D)


DRIFT_STEPS = 24
# Limits set from the first run of these checks on one H100 (PERF.md): the
# forced chain came within 2.0e-5 of the K3 chain; the mixed trainer's mean
# and max distance from the single-device run were 0.74x and 0.64x those of
# the single-device run on the data moved up one ulp
DRIFT_FORCED_ATOL = 1e-4
DRIFT_RATIO = 2.0


def spread(a, b) -> dict:
    """How far codebook `a` is from `b`: max and mean |a - b| and the share
    of entries off by more than 1e-3."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                share_off_by_1e_3=float((d > 1e-3).mean()))


def up_one_ulp(a):
    return np.nextafter(a, np.float32(np.inf)).astype(np.float32)


def k3_chain(X, nudge=None):
    """The drift chain on one card: K1 for batch 0's winners, then
    DRIFT_STEPS K3 steps over drift_inputs(X) (batch t + 1, batch 0 after
    the last, the next batch); with `nudge` "codes" or "data" from the
    codebook or on the data moved up by one ulp.  Returns (the codebook,
    (DRIFT_STEPS + 1, 4096) winners: batch 0's, then each step's next
    batch's)."""
    import torch

    from som_lvq_pak_torch.ops.dist_argmin import dist_argmin
    from som_lvq_pak_torch.ops.som_step import som_fused_train_step

    codes, batches, alphas, radii = drift_inputs(X)
    if nudge == "codes":
        codes = up_one_ulp(codes)
    elif nudge == "data":
        batches = up_one_ulp(batches)
    M = torch.from_numpy(codes).to("cuda")
    xs = torch.from_numpy(batches).to("cuda")
    seq = [dist_argmin(xs[0], M)[1]]
    for t in range(DRIFT_STEPS):
        seq.append(som_fused_train_step(M, xs[t], seq[-1], xs[(t + 1) % DRIFT_STEPS],
                                        256, True, float(alphas[t]), float(radii[t]),
                                        True, factored=False)[1])
    return M.cpu().numpy(), torch.stack(seq).cpu().numpy()


def drift_inputs(X):
    """The drift chains' inputs from phase 15's 100k rows: the random-init
    256x256 codebook, DRIFT_STEPS batches of 4096 rows in order, and the
    trainer's alpha (0.05, linear) and radius (64) at each batch."""
    from som_lvq_pak_torch.models.common import alpha_schedule, radius_schedule

    bs = 4096
    rlen = DRIFT_STEPS * bs
    return (random_codes(X, 256).points, X[:rlen].reshape(DRIFT_STEPS, bs, -1),
            alpha_schedule(rlen, 0.05)[::bs], radius_schedule(rlen, 64.0)[::bs])


def mixed_chain(mesh, step, X, bmu_ref, forced):
    """The drift chain through the mixed step on this rank's shards, as the
    trainer runs it: DRIFT_STEPS steps from drift_inputs(X), batch t + 1
    (batch 0 after the last) the next batch, the first winners bmu_ref[0]
    (the K3 chain's).  Each step takes the previous step's own winners, or
    with `forced` the K3 chain's (bmu_ref[t]).  Returns (the whole codebook,
    per step the number of the step's winners that differ from the K3
    chain's)."""
    import torch

    codes, batches, alphas, radii = drift_inputs(X)
    n, T, B = codes.shape[0], batches.shape[0], batches.shape[1]
    rows, bs = mesh.rows(n), mesh.batch_rows(B)
    xs = torch.from_numpy(np.ascontiguousarray(batches[:, bs])).to(mesh.device)
    ref = torch.from_numpy(np.ascontiguousarray(bmu_ref[:, bs])).to(mesh.device)
    c = torch.from_numpy(codes[rows]).to(mesh.device)
    bmu, flips = ref[0], []
    for t in range(T):
        c, own = step.local(c, xs[t], bmu, xs[(t + 1) % T], float(alphas[t]),
                            float(radii[t]), rows.start)
        flips.append((own != ref[t + 1]).sum())
        bmu = ref[t + 1] if forced else own
    return (mesh.gather_rows(c, n),
            mesh.all_reduce(torch.stack(flips).to(torch.int32), "data"))


def mesh_22_world(mesh, rlen, bmu_ref):
    """Phases 15 and 17 on each rank of the (data 2, model 2) world: one
    mixed step from step_inputs() (make_mixed_fused_som_train_step with two
    row segments), the drift chains (mixed_chain, free and forced, against
    the K3 chain's winners `bmu_ref`), the trainer's mixed path, then
    OLVQ1Trainer(mesh=) for `rlen` streamed rows and LVQTrainer("lvq3",
    mesh=) for as many from its codebook."""
    import torch

    from som_lvq_pak_torch.parallel.sharded import make_mixed_fused_som_train_step

    step = make_mixed_fused_som_train_step(mesh, True, 256, True, overlap_segments=2)
    args = [torch.from_numpy(a).to(mesh.device) for a in step_inputs()]
    X = blob_data(7, 1_000_000, 16)[:100_000]
    out = {"mixed_step": rank_fit(mesh, lambda: step(*args, 0.05, 64.0))[1],
           "drift_free": rank_fit(mesh, lambda: mixed_chain(mesh, step, X, bmu_ref,
                                                            False))[1],
           "drift_forced": rank_fit(mesh, lambda: mixed_chain(mesh, step, X, bmu_ref,
                                                              True))[1],
           "mixed": mesh_som(mesh, X, 256, 4096, 64)}
    X, lab, _ = lvq_data()
    codes = lvq_codes(X, lab, 65536)
    trained, out["olvq1"] = rank_fit(mesh, lambda: olvq1_trainer(codes, mesh=mesh).fit(
        som_stream(X, 16384, rlen, labels=lab), rlen=rlen))
    out["lvq3"] = rank_fit(mesh, lambda: lvq_trainer("lvq3")(trained, mesh=mesh).fit(
        som_stream(X, 16384, rlen, labels=lab), rlen=rlen, alpha=0.01))[1]
    return out


def mesh_masked_world(mesh):
    """Phase 16 on each rank of the (data 2, model 1) world: phase 6's
    stream."""
    Xm, mask, weight = masked_stream_data()
    return {"masked": mesh_som(mesh, Xm, 128, 1024, 32, chunk=8192, mask=mask,
                               weight=weight)}


def masked_stream_data():
    """Phase 6's data: the 100k blobs with every other 8192-row chunk
    masked, and weight= tokens."""
    Xm, mask, rng = masked_data(blob_data(42, 100_000, 4), 43, 8192, every_other=True)
    return Xm, mask, rng.uniform(0.5, 2.0, size=Xm.shape[0]).astype(np.float32)


def run_world(fn, data, model, kernels, *args):
    """`fn` on every rank of a data x model world on this card.  Each rank
    returns {fit name: record}; every rank must return the same codebooks
    and have launched each of kernels[fit name] in that fit (and K1's
    prologue with K1: with_prologue).  Returns
    {fit name: [each rank's record]}, the launches summed over ranks and
    fits, and the world's wall (spawn to exit)."""
    from som_lvq_pak_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    ranks = spawn(fn, data, model, "cuda", *args, timeout_s=MESH_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    fits = {name: [r[name] for r in ranks] for name in ranks[0]}
    total = {}
    for name, recs in fits.items():
        if any(not np.array_equal(r["codes"], recs[0]["codes"]) for r in recs):
            raise AssertionError(f"{name}: the ranks returned different codebooks")
        for rank, rec in enumerate(recs):
            idle = [k for k in with_prologue(kernels[name]) if rec["launches"][k] == 0]
            if idle:
                raise AssertionError(f"{name}: rank {rank} never launched {idle}")
            for k, n in rec["launches"].items():
                total[k] = total.get(k, 0) + n
    return fits, total, world_s


def world_record(recs):
    """What a mesh phase prints of its fit: backend, layout, train_s (the
    slowest rank's) and each rank's nonzero launch counts."""
    return dict(backend=recs[0]["backend"], layout=recs[0]["layout"], ranks=len(recs),
                train_s=max(r["train_s"] for r in recs),
                launches_per_rank=[{k: n for k, n in r["launches"].items() if n}
                                   for r in recs])


def masked_data(X, seed, chunk, every_other):
    """bench.py's e2e data with missing components: each component masked
    with p = 0.1 and every 997th row fully masked (default_rng(seed)); with
    every_other, the odd-numbered chunks carry no mask.  Masked components
    are stored as 0, as the reference stores them."""
    rng = np.random.default_rng(seed)
    mask = (rng.random(X.shape) < 0.1).astype(np.uint8)
    mask[::997] = 1
    if every_other:
        for lo in range(chunk, X.shape[0], 2 * chunk):
            mask[lo:lo + chunk] = 0
    return np.where(mask != 0, np.float32(0), X), mask, rng


def check_e2e(name, q, q_plain, rel=0.01):
    if not (np.isfinite(q) and abs(q - q_plain) <= rel * q_plain):
        raise AssertionError(f"{name}: qerror {q} vs plain {q_plain} (> {rel:.1%})")


def som_batch_steps(X, map_dim, bs, steps):
    """`steps` unmasked two-kernel steps (models.fast.som_batch_step) from
    the random-init codebook; returns the codebook."""
    import torch

    from som_lvq_pak_torch.convert import codebook_to_torch
    from som_lvq_pak_torch.models.fast import som_batch_step

    M = codebook_to_torch(random_codes(X, map_dim), "cuda")[0]
    X_dev = torch.from_numpy(X[:steps * bs]).to("cuda")
    for t in range(steps):
        som_batch_step(M, X_dev[t * bs:(t + 1) * bs], map_dim, True, 0.05, 32.0,
                       gaussian=True)
    torch.cuda.synchronize()
    return M


def online_run(X, rlen, mask=None):
    """The online scan, som_train(mode="fast"), on the card: a 64x64 hexa
    gaussian random-init map over the first `rlen` rows of X (D 64) in file
    order, alpha 0.05, radius 16; returns (per-sample qerror over X,
    train_s, the codebook)."""
    import torch

    from som_lvq_pak_torch.models.som import Dataset, find_qerror, som_train

    data = Dataset(points=X, mask=mask)
    codes = random_codes(X, 64, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = som_train(codes, data, rlen, 0.05, 16.0, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if not np.isfinite(out.points).all() or out.points.shape != (4096, 64):
        raise AssertionError("online scan: codebook not finite or of the wrong shape")
    return find_qerror(out, data, device="cuda") / X.shape[0], train_s, out


def train_fast_run(X, map_dim, bs, rlen, radius):
    """models.fast.som_train_fast on the card from the random-init map;
    returns (per-sample qerror over X, train_s, the codebook)."""
    import torch

    from som_lvq_pak_torch.models.fast import som_train_fast
    from som_lvq_pak_torch.models.som import Dataset, find_qerror

    data = Dataset(points=X)
    codes = random_codes(X, map_dim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = som_train_fast(codes, data, rlen, 0.05, radius, batch_size=bs, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    return find_qerror(out, data, device="cuda") / X.shape[0], train_s, out


VFIND_PHASES = [(2048, 0.05, 4.0), (2048, 0.02, 2.0)]


def vfind_run(data):
    """bench.py:prep_vfind's row on the card: vfind_trials, 8 trials of a
    16x16 hexa gaussian map, B 128; returns (best trial, {trial: qerror},
    the best codebook, vfind_s)."""
    import torch

    from som_lvq_pak_torch.models.som import Neighborhood, Topology, vfind_trials

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, trial, _, qs = vfind_trials(data, data, 8, Topology.HEXA, Neighborhood.GAUSSIAN,
                                      16, 16, VFIND_PHASES, batch_size=128, device="cuda")
    torch.cuda.synchronize()
    return trial, qs, best, time.perf_counter() - t0


def qerror2_cases(cases):
    """find_qerror2(mode="fast") on the card for each (name, codebook, data
    tensor, mask tensor, radius); the last case is timed, with the peak of
    allocated device memory during it.  Returns ({name: qerror2},
    qerror2_eval_s, peak GiB)."""
    import torch

    from som_lvq_pak_torch.models.som import find_qerror2

    out = {}
    for name, codes, X, mask, radius in cases[:-1]:
        out[name] = find_qerror2(codes, X, radius, mask=mask)
    name, codes, X, mask, radius = cases[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out[name] = find_qerror2(codes, X, radius, mask=mask)
    eval_s = time.perf_counter() - t0
    return out, eval_s, torch.cuda.max_memory_allocated() / 2 ** 30


def som_model_phases(smi, tally, X, Xm, mask):
    """Phases 6a-6c: the online scan on phase 4's rows `X` and phase 6's
    masked rows `Xm` (`mask`), som_train_fast on `X`, and vfind; each
    through the kernels, the plain versions and again; `tally(launches)`
    takes each run's counts."""
    import torch

    from som_lvq_pak_torch.models.som import (Dataset, Neighborhood, Topology,
                                              find_qerror, vfind_codebooks)

    # ---- the online scan: som_train(mode="fast"), K1 (K4 masked) at B 1 ---
    # 20,000 steps over phase 4's rows, then 5,000 over phase 6's masked
    # rows (every step K4); each run again, bit-equal, and through the plain
    # versions on the card
    t0 = time.perf_counter()
    runs = {}
    for label, rows, mk, rlen, kernels in (
            ("", X, None, 20_000, ("dist_argmin",)),
            (" masked", Xm, mask, 5_000, ("dist_argmin_masked",))):
        (q, train_s, out), (q_plain, train_plain_s, _), got = main_path(
            "e2e_som_online_64x64" + label, lambda: online_run(rows, rlen, mk), kernels,
            lambda: online_run(rows, rlen, mk))
        tally(got)
        check_e2e("online 64" + label, q, q_plain)
        _, train2_s, again = online_run(rows, rlen, mk)
        if not np.array_equal(again.points.view(np.int32), out.points.view(np.int32)):
            raise AssertionError(f"online 64{label}: a rerun on the card is not bit-equal")
        rows_dev = torch.from_numpy(rows).to("cuda")
        q_init = find_qerror(random_codes(rows, 64, mk), rows_dev,
                             mask=None if mk is None else torch.from_numpy(mk).to("cuda"))
        q_init /= rows.shape[0]
        if not q < q_init:
            raise AssertionError(f"online 64{label}: qerror {q} not below the random-init "
                                 f"{q_init}")
        runs[label.strip() or "clean"] = dict(
            rlen=rlen, qerror_per_sample=q, plain_qerror_per_sample=q_plain,
            random_init_qerror_per_sample=q_init, train_s=train_s, rerun_train_s=train2_s,
            plain_train_s=train_plain_s, samples_per_s=rlen / train_s, launches=got,
            rerun_bit_equal=True)
        del rows_dev
    # phase_s: the whole line, its plain runs, reruns and evaluations included
    emit("e2e_som_online_64x64", card=smi, **runs, phase_s=time.perf_counter() - t0,
         gate="qerror within 1% of the plain run and below the random-init qerror; "
              "a rerun bit-equal")

    # ---- som_train_fast: the minibatch trainer, K1 + K5 per batch ---------
    t0 = time.perf_counter()
    run = lambda: train_fast_run(X, 128, 1024, 100_000, 32.0)  # noqa: E731
    (q, train_s, out), (q_plain, train_plain_s, _), got = main_path(
        "e2e_som_train_fast_128x128_100k", run,
        ("dist_argmin", "som_neighborhood_update_idx"), run)
    tally(got)
    check_e2e("som_train_fast 128", q, q_plain)
    _, _, again = run()
    if not np.array_equal(again.points.view(np.int32), out.points.view(np.int32)):
        raise AssertionError("som_train_fast 128: a rerun on the card is not bit-equal")
    q_init = find_qerror(random_codes(X, 128), torch.from_numpy(X).to("cuda")) / X.shape[0]
    if not q < q_init:
        raise AssertionError(f"som_train_fast 128: qerror {q} not below the random-init "
                             f"{q_init}")
    emit("e2e_som_train_fast_128x128_100k", card=smi, steps=100_000 // 1024, batch=1024,
         qerror_per_sample=q, plain_qerror_per_sample=q_plain,
         random_init_qerror_per_sample=q_init, train_s=train_s,
         plain_train_s=train_plain_s, launches=got, rerun_bit_equal=True,
         phase_s=time.perf_counter() - t0,
         gate="qerror within 1% of the plain run and below the random-init qerror; "
              "a rerun bit-equal")

    # ---- vfind: 8 trials at once (bench.py:prep_vfind), K1 + K5, K2 -------
    t0 = time.perf_counter()
    vdata = Dataset(points=np.random.default_rng(9).normal(
        0, 1, size=(2048, 16)).astype(np.float32))
    (trial, qs, best, vfind_s), (trial_plain, qs_plain, _, vfind_plain_s), got = main_path(
        "e2e_vfind_8x16x16", lambda: vfind_run(vdata),
        ("dist_argmin", "som_neighborhood_update_idx", "dist_argmin_t"),
        lambda: vfind_run(vdata))
    tally(got)
    for t in qs:
        check_e2e(f"vfind trial {t}", qs[t], qs_plain[t])
    ranked = sorted(qs_plain.values())
    if trial != trial_plain and ranked[1] - ranked[0] > 0.01 * ranked[0]:
        raise AssertionError(f"vfind: best trial {trial}, plain {trial_plain}")
    vkw = dict(topol=Topology.HEXA, neigh=Neighborhood.GAUSSIAN, xdim=16, ydim=16,
               phases=VFIND_PHASES, batch_size=128, device="cuda")
    all8 = vfind_codebooks(vdata, list(range(8, 0, -1)), **vkw)
    if not (bits_equal(all8[0], vfind_codebooks(vdata, [8], **vkw)[0])
            and bits_equal(all8[8 - trial].cpu(), torch.from_numpy(best.points))):
        raise AssertionError("vfind: a trial's codebook depends on the trials beside it")
    emit("e2e_vfind_8x16x16", card=smi, best_trial=trial, plain_best_trial=trial_plain,
         qerror_per_sample={t: q / 2048 for t, q in qs.items()},
         plain_qerror_per_sample={t: q / 2048 for t, q in qs_plain.items()},
         vfind_s=vfind_s, plain_vfind_s=vfind_plain_s, launches=got,
         trial8_bit_equal_to_one_trial=True, phase_s=time.perf_counter() - t0,
         gate="each trial's qerror within 1% of the plain run's; the same best trial "
              "unless the plain run's two best are within 1%; trial 8 bit-equal to a "
              "one-trial call")


def qerror2_phase(smi, tally, c128, X100, cm128, Xm128, mask128, c256, X):
    """Phase 8a: find_qerror2(mode="fast") on phase 4's codebook `c128` and
    its rows `X100` at radius 1 and 8, gaussian and as bubble; on phase 6's
    masked codebook `cm128` and rows (`Xm128`, `mask128`); last (timed, with
    the peak of device memory) on phase 8's `c256` and its 1M rows `X` at
    radius 1.  Each within 0.1% of the plain run."""
    import torch

    from som_lvq_pak_torch.models.som import Neighborhood

    t0 = time.perf_counter()
    dev = lambda a: torch.from_numpy(a).to("cuda")  # noqa: E731
    X100_dev, Xm_dev, m_dev, X_dev = dev(X100), dev(Xm128), dev(mask128), dev(X)
    cases = [(f"128x128_{neigh}_r{r:g}", replace(c128, neigh=nb), X100_dev, None, r)
             for neigh, nb in (("gaussian", Neighborhood.GAUSSIAN),
                               ("bubble", Neighborhood.BUBBLE))
             for r in (1.0, 8.0)]
    cases += [("masked_128x128_r1", cm128, Xm_dev, m_dev, 1.0),
              ("256x256_1M_r1", c256, X_dev, None, 1.0)]
    (q2, q2_s, peak), (q2_plain, q2_plain_s, _), got = main_path(
        "e2e_qerror2", lambda: qerror2_cases(cases), ("dist_argmin", "dist_argmin_masked"),
        lambda: qerror2_cases(cases))
    tally(got)
    for name in q2:
        if not (np.isfinite(q2[name]) and abs(q2[name] - q2_plain[name])
                <= 1e-3 * q2_plain[name]):
            raise AssertionError(f"qerror2 {name}: {q2[name]} vs plain {q2_plain[name]} "
                                 "(> 0.1%)")
    emit("e2e_qerror2", card=smi, qerror2=q2, plain_qerror2=q2_plain,
         qerror2_eval_s=q2_s, plain_qerror2_eval_s=q2_plain_s, peak_gib=peak,
         launches=got, phase_s=time.perf_counter() - t0,
         gate="each value within 0.1% of the plain run on the card")


def mesh_phases(smi, tally, q_masked128):
    """Phases 14-17: each mesh world against the single-device port run on
    the same data; `tally(launches)` takes each run's counts, `q_masked128`
    is phase 6's qerror."""
    import torch

    from som_lvq_pak_torch.models.eval import accuracy
    from som_lvq_pak_torch.models.som import Dataset, find_qerror
    from som_lvq_pak_torch.models.trainer import SOMTrainer
    from som_lvq_pak_torch.ops.som_step import som_fused_train_step

    def single_som(X, map_dim, name, nudge=None):
        """The single-device port run a mesh phase is gated on: the same
        Dataset, batch, schedule and seed (K1 prologue, K3 per step); with
        `nudge` "codes" or "data" from the random-init codebook or on the
        data moved up by one ulp."""
        codes = random_codes(X, map_dim)
        if nudge == "codes":
            codes = replace(codes, points=up_one_ulp(codes.points))
        data = Dataset(points=up_one_ulp(X) if nudge == "data" else X)

        def run():
            t0 = time.perf_counter()
            out = SOMTrainer(codes, batch_size=4096, device="cuda").fit(
                data, rlen=X.shape[0], alpha=0.05, radius=64)
            torch.cuda.synchronize()
            return out.points, time.perf_counter() - t0

        (codes_1, train_1), _, got = main_path(name, run,
                                               ("dist_argmin", "som_fused_train_step"))
        tally(got)
        return codes_1, train_1

    def som_gates(name, codes_m, codes_1, X, mask=None, codebook=None):
        """qerror of the mesh codebook within 1% of the single-device one's
        (`codes_1`, or its qerror).  codebook "equal": the two codebooks
        bit for bit (the TP step runs K3's arithmetic on every row); a
        spread() of the single-device run from itself on the data moved up
        by one ulp: the mesh codebook's mean and max distance from `codes_1`
        each at most DRIFT_RATIO times that spread's (the mixed step sums each
        row's accumulators in two halves, so it differs from K3 by rounding,
        and near-tie winner flips carry any rounding difference over the map: the
        forced drift chain shows the step without flips stays on K3).  The
        record is printed before a failed gate raises."""
        X_dev = torch.from_numpy(X).to("cuda")
        mk = None if mask is None else torch.from_numpy(mask).to("cuda")
        q_m = find_qerror(torch.from_numpy(codes_m).to("cuda"), X_dev, mask=mk) / X.shape[0]
        q_1 = codes_1 if codebook is None else (
            find_qerror(torch.from_numpy(codes_1).to("cuda"), X_dev, mask=mk) / X.shape[0])
        rec = dict(qerror_per_sample=q_m, single_qerror_per_sample=q_1,
                   gate="qerror within 1% of the single-device run")
        ok = bool(np.isfinite(q_m) and abs(q_m - q_1) <= 0.01 * q_1)
        if codebook is not None:
            rec["codebook"] = got = spread(codes_m, codes_1)
            if codebook == "equal":
                ok = ok and np.array_equal(codes_m, codes_1)
                rec["gate"] += ", codebook bit-equal to it"
            else:
                rec["single_nudged_data"] = codebook
                ok = ok and all(got[k] <= DRIFT_RATIO * codebook[k]
                                for k in ("max_abs", "mean_abs"))
                rec["gate"] += (f", codebook mean and max |diff| each within "
                                f"{DRIFT_RATIO}x those of the single-device run on "
                                f"the data moved up by one ulp")
        if not ok:
            emit(name + " failed", **rec)
            raise AssertionError(f"{name}: gate failed: {rec}")
        return rec

    # (data 1, model 2): the pure-TP fused step on the 1M data
    X = blob_data(7, 1_000_000, 16)
    codes_1, train_1 = single_som(X, 256, "e2e_mesh_tp_256x256_1M single device")
    fits, got, world_s = run_world(mesh_tp_world, 1, 2,
                                   {"tp": ("dist_argmin", "som_fused_train_step")})
    tally(got)
    emit("e2e_mesh_tp_256x256_1M", card=smi, **world_record(fits["tp"]),
         world_s=world_s, single_train_s=train_1,
         **som_gates("e2e_mesh_tp_256x256_1M", fits["tp"][0]["codes"], codes_1, X,
                     codebook="equal"))

    # (data 2, model 2): the mixed step on the first 100k rows, then the LVQ
    # trainers on 262,144 rows of the 1M labelled vectors
    X = X[:100_000].copy()
    codes_1, train_1 = single_som(X, 256, "e2e_mesh_mixed_256x256_100k single device")
    # how far the single-device run drifts from itself at a rounding
    # difference: the same run from the codebook, or on the data, moved up
    # by one ulp (the trainer, and the drift chain)
    nudged = {kind: spread(single_som(X, 256, f"e2e_mesh_mixed_256x256_100k nudged "
                                      f"{kind}", nudge=kind)[0], codes_1)
              for kind in ("codes", "data")}
    (chain_1, bmu_ref), _, got = main_path("drift chain, K3", lambda: k3_chain(X),
                                           ("dist_argmin", "som_fused_train_step"))
    tally(got)
    chain_nudged = {}
    for kind in ("codes", "data"):
        (chain_n, _), _, got = main_path(f"drift chain, K3 nudged {kind}",
                                         lambda: k3_chain(X, nudge=kind),
                                         ("dist_argmin", "som_fused_train_step"))
        tally(got)
        chain_nudged[kind] = spread(chain_n, chain_1)
    rlen = 262_144
    mixed_kernels = ("som_neighborhood_accumulate", "som_blend_winner")
    fits, got, world_s = run_world(
        mesh_22_world, 2, 2,
        {"mixed": mixed_kernels + ("dist_argmin",),
         "olvq1": ("dist_argmin", "segment_sum"), "lvq3": ("dist_topk", "segment_sum"),
         "mixed_step": mixed_kernels,
         "drift_free": mixed_kernels, "drift_forced": mixed_kernels}, rlen, bmu_ref)
    tally(got)
    drift = dict(
        steps=DRIFT_STEPS,
        forced=dict(spread(fits["drift_forced"][0]["codes"], chain_1),
                    winners_differ_per_step=fits["drift_forced"][0]["winners"].tolist()),
        free=dict(spread(fits["drift_free"][0]["codes"], chain_1),
                  winners_differ_per_step=fits["drift_free"][0]["winners"].tolist()),
        k3_nudged=chain_nudged,
        gate=f"forced chain within {DRIFT_FORCED_ATOL} of the K3 chain everywhere")
    if not drift["forced"]["max_abs"] <= DRIFT_FORCED_ATOL:
        emit("e2e_mesh_mixed_256x256_100k failed", drift=drift)
        raise AssertionError(f"mixed drift chain: forced chain off the K3 chain: {drift}")
    # the world's one mixed step against K3 on the whole map, same inputs
    c, xb, bmu, xn = (torch.from_numpy(a).to("cuda") for a in step_inputs())
    c3, i3, _ = som_fused_train_step(c, xb, bmu, xn, 256, True, 0.05, 64.0, True,
                                     factored=False)
    got_c = torch.from_numpy(fits["mixed_step"][0]["codes"]).to("cuda")
    got_i = torch.from_numpy(fits["mixed_step"][0]["winners"]).to("cuda")
    step_diff = float((got_c - c3).abs().max())
    if not torch.allclose(got_c, c3, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"mixed step: codes differ from K3's by {step_diff}")
    step_flips = check_winners("mixed step", xn, c3, got_i, i3)
    emit("e2e_mesh_mixed_256x256_100k", card=smi, **world_record(fits["mixed"]),
         world_s=world_s, single_train_s=train_1,
         one_step=dict(world_record(fits["mixed_step"]),
                       max_abs_diff_from_k3=step_diff, winners_differ=step_flips,
                       gate="codes within 1e-5 of K3 on the whole map, winners "
                            "equal except at near-ties"),
         drift=drift, single_nudged_codes=nudged["codes"],
         **som_gates("e2e_mesh_mixed_256x256_100k", fits["mixed"][0]["codes"], codes_1, X,
                     codebook=nudged["data"]))
    del X
    X, lab, table = lvq_data()
    data = Dataset(points=X, labels=lab)

    codes = lvq_codes(X, lab, 65536)

    def single_lvq():
        t0 = time.perf_counter()
        o = olvq1_trainer(codes).fit(
            som_stream(X, 16384, rlen, labels=lab), rlen=rlen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        l3 = lvq_trainer("lvq3")(o).fit(som_stream(X, 16384, rlen, labels=lab),
                                        rlen=rlen, alpha=0.01)
        torch.cuda.synchronize()
        return o, l3, t1 - t0, time.perf_counter() - t1

    (o_1, l3_1, t_o, t_3), _, got = main_path(
        "e2e_mesh_lvq_65536 single device", single_lvq, ("dist_argmin", "dist_top2"))
    tally(got)
    lvq_rec = {}
    for name, single, t_1 in (("olvq1", o_1, t_o), ("lvq3", l3_1, t_3)):
        trained = Dataset(points=fits[name][0]["codes"], labels=o_1.labels,
                          topol=o_1.topol)
        pct = accuracy(data, trained, labels=table, device="cuda")[0]
        pct_1 = accuracy(data, single, labels=table, device="cuda")[0]
        check_accuracy(f"e2e_mesh_lvq_65536 {name}", pct, pct_1)
        lvq_rec[name] = dict(world_record(fits[name]), accuracy_pct=pct,
                             single_accuracy_pct=pct_1, single_train_s=t_1)
    emit("e2e_mesh_lvq_65536", card=smi, rows=rlen, world_s=world_s,
         gate="each accuracy within 0.5 points of the single-device run", **lvq_rec)
    del X, lab, data

    # (data 2, model 1): the two-pass step on phase 6's masked stream
    Xm, mask, _ = masked_stream_data()
    fits, got, world_s = run_world(mesh_masked_world, 2, 1,
                                   {"masked": ("dist_argmin", "dist_argmin_masked")})
    tally(got)
    emit("e2e_mesh_masked_stream_128x128_100k", card=smi, **world_record(fits["masked"]),
         world_s=world_s,
         **som_gates("e2e_mesh_masked_stream_128x128_100k", fits["masked"][0]["codes"],
                     q_masked128, Xm, mask))


# ---- phases 18 and 19: the dryrun and overlap_chunks; the two torchrun hosts --

OVERLAP_STEPS = 16
OVERLAP_MAP, OVERLAP_B = 256, 4096  # the north-star shape
DRYRUN_KERNELS = ("dist_argmin", "som_fused_train_step", "som_neighborhood_update_idx",
                  "dist_topk", "som_neighborhood_accumulate", "som_blend_winner",
                  "segment_sum")


def mesh_dryrun_phase(smi, tally):
    """Phase 18: som_lvq_pak_torch.dryrun.dryrun_multichip(4) (a (data 2,
    model 2) world on the card(s) by the backend rule; every rank zeroes
    its counters first and returns them) and entry() once; each rank must
    have launched K1, K3, K5, K10, K11, K12 and the segment sum, entry K1
    and K5."""
    import torch

    from som_lvq_pak_torch import dryrun

    t0 = time.perf_counter()
    ranks = dryrun.dryrun_multichip(4, device="cuda", timeout_s=MESH_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    for rank, r in enumerate(ranks):
        idle = [k for k in DRYRUN_KERNELS if r["launches"][k] == 0]
        if idle:
            raise AssertionError(f"mesh_dryrun: rank {rank} never launched {idle}")
        tally(r["launches"])
    fn, args = dryrun.entry(device="cuda")

    def run():
        out = fn(*args)
        torch.cuda.synchronize()
        return out

    out, ref, got = main_path("mesh_dryrun entry", run,
                              ("dist_argmin", "som_neighborhood_update_idx"), run)
    tally(got)
    if out.shape != (512, 64) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"entry: codebook {tuple(out.shape)} not finite")
    emit("mesh_dryrun", card=smi, backend=ranks[0]["backend"],
         devices=[r["device"] for r in ranks], layout=[ranks[0]["data"], ranks[0]["model"]],
         summary=dryrun.summary(ranks[0]), world_s=world_s,
         launches_per_rank=[{k: n for k, n in r["launches"].items() if n} for r in ranks],
         entry=dict(launches={k: n for k, n in got.items() if n},
                    max_abs_diff_from_plain=float((out - ref).abs().max())))


def overlap_inputs():
    """The overlap phase's 16 steps: bench.py's e2e_256x256_1M data
    (default_rng(7)), its CRandom(123) random-init 256x256 codebook, the
    first 16 batches of 4096 rows and the trainer's alpha (0.05, linear)
    and radius (64) at each batch."""
    from som_lvq_pak_torch.models.common import alpha_schedule, radius_schedule

    X = blob_data(7, 1_000_000, 16)
    bs, rlen = OVERLAP_B, OVERLAP_STEPS * OVERLAP_B
    return (random_codes(X, OVERLAP_MAP).points, X[:rlen].reshape(OVERLAP_STEPS, bs, -1).copy(),
            alpha_schedule(rlen, 0.05)[::bs].copy(), radius_schedule(rlen, 64.0)[::bs].copy())


def mesh_overlap_world(mesh, codes, batches, alphas, radii):
    """Phase 19 on each rank of the (data 2, model 2) world.  First along
    the overlap_chunks=1 chain of 16 two-pass steps of
    make_sharded_som_train_step(gaussian=True): each step's winners by
    sharded_winner_search and by chunked_winner_search in 4 pieces, and on
    rank 0 the same step through the one-device som_batch_step (K1 + K5)
    from the chain's codebook; on rank 0 also the 16 one-device steps from
    the start (the free chain).  This pass also opens the communicators.
    Then the 16 steps at overlap_chunks 1, 4, 4, 1, 1, 4, 4, 1 from the
    same codebook, each run timed by CUDA events (ms per step), the
    counters zeroed before them and read after."""
    import torch
    import torch.distributed as dist

    from som_lvq_pak_torch.models.fast import som_batch_step, unit_coords
    from som_lvq_pak_torch.parallel.sharded import (chunked_winner_search,
                                                    make_sharded_som_train_step,
                                                    sharded_winner_search)

    dev = mesh.device
    n, T = codes.shape[0], batches.shape[0]
    coords = unit_coords(OVERLAP_MAP, OVERLAP_MAP, True, device=dev)
    xs = torch.from_numpy(batches).to(dev)
    c0 = torch.from_numpy(codes).to(dev)
    steps = {k: make_sharded_som_train_step(mesh, gaussian=True, overlap_chunks=k)
             for k in (1, 4)}
    rows, bs, nl = mesh.rows(n), mesh.batch_rows(batches.shape[1]), mesh.block(n)
    c, differ, step_diff = c0, [], []
    for t in range(T):
        xl, cl = xs[t][bs], c[rows].contiguous()
        w1 = sharded_winner_search(mesh, xl, cl, nl)[1]
        w4 = chunked_winner_search(mesh, xl, cl, nl, 4)
        differ.append(int((w1 != w4).sum()))
        nxt = steps[1](c, xs[t], coords, float(alphas[t]), float(radii[t]))
        if mesh.rank == 0:
            one = som_batch_step(c.clone(), xs[t], OVERLAP_MAP, True, float(alphas[t]),
                                 float(radii[t]), gaussian=True)
            step_diff.append(float((one - nxt).abs().max()))
        c = nxt
    free = None
    if mesh.rank == 0:
        m = c0.clone()
        for t in range(T):
            som_batch_step(m, xs[t], OVERLAP_MAP, True, float(alphas[t]),
                           float(radii[t]), gaussian=True)
        free = m.cpu().numpy()

    def chain(k):
        c = c0
        for t in range(T):
            c = steps[k](c, xs[t], coords, float(alphas[t]), float(radii[t]))
        return c

    for fn in counted():
        fn.launches = 0
    ms, finals, rerun_equal = {1: [], 4: []}, {1: c}, True
    for k in (1, 4, 4, 1, 1, 4, 4, 1):
        dist.barrier()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        got = chain(k)
        e1.record()
        torch.cuda.synchronize()
        ms[k].append(e0.elapsed_time(e1) / T)
        rerun_equal = rerun_equal and torch.equal(finals.setdefault(k, got), got)
    launches = {fn.__name__: fn.launches for fn in counted()}
    dist.barrier()
    return {"overlap": dict(codes=finals[1].cpu().numpy(), codes4=finals[4].cpu().numpy(),
                            rerun_equal=rerun_equal, ms=ms, launches=launches,
                            backend=mesh.backend, layout=mesh.shape, device=str(dev),
                            winners_differ=differ, step_max_abs=step_diff, free=free)}


def mesh_overlap_phase(smi, tally):
    """Phase 19: e2e_mesh_overlap_256x256 (data 2, model 2); the gates of
    the module docstring."""
    import torch

    from som_lvq_pak_torch.models.som import find_qerror

    codes, batches, alphas, radii = overlap_inputs()
    fits, got, world_s = run_world(mesh_overlap_world, 2, 2,
                                   {"overlap": ("dist_argmin",)},
                                   codes, batches, alphas, radii)
    tally(got)
    recs = fits["overlap"]
    r0 = recs[0]
    X_dev = torch.from_numpy(batches.reshape(-1, batches.shape[2])).to("cuda")
    q = {name: find_qerror(torch.from_numpy(c).to("cuda"), X_dev) / X_dev.shape[0]
         for name, c in (("start", codes), ("k1", r0["codes"]), ("free_one_device", r0["free"]))}
    d14 = np.abs(r0["codes"].astype(np.float64) - r0["codes4"]).max()
    runs = {k: [max(r["ms"][k][i] for r in recs) for i in range(len(r0["ms"][k]))]
            for k in (1, 4)}
    rec = dict(
        card=smi, backend=r0["backend"], layout=r0["layout"],
        devices=[r["device"] for r in recs], steps=OVERLAP_STEPS, world_s=world_s,
        ms_per_step_median={f"k{k}": float(np.median(runs[k])) for k in (1, 4)},
        ms_per_step_each_run={f"k{k}": runs[k] for k in (1, 4)},
        order="k 1, 4, 4, 1, 1, 4, 4, 1 after an untimed pass; each run the slowest rank",
        timing=("over gloo on one card every rank shares the card and stages its "
                "collectives through host memory: an equality check, not an overlap "
                "measurement") if r0["backend"] == "gloo" else "NCCL, one card per rank",
        k1_launches_per_rank=[r["launches"]["dist_argmin"] for r in recs],
        launches_per_rank=[{k: n for k, n in r["launches"].items() if n} for r in recs],
        codebook_k1_vs_k4_max_abs=float(d14),
        winners_differ_per_step=r0["winners_differ"],
        one_device_step_max_abs=r0["step_max_abs"],
        free_one_device_chain=spread(r0["codes"], r0["free"]),
        qerror_per_sample=q,
        gate=("k 1 and k 4 codebooks and every step's winners bit-equal, every run "
              "bit-equal to the checked chain; each step within 1e-4 of the "
              "one-device som_batch_step (K1 + K5) from the same codebook; the "
              "qerror falling"))
    ok = (d14 == 0 and not any(r0["winners_differ"]) and all(r["rerun_equal"] for r in recs)
        and max(r0["step_max_abs"]) <= 1e-4 and q["k1"] < q["start"])
    if not ok:
        emit("e2e_mesh_overlap_256x256 failed", **rec)
        raise AssertionError(f"e2e_mesh_overlap_256x256: gate failed: {rec}")
    emit("e2e_mesh_overlap_256x256", **rec)


def multihost_data(path):
    """tests/test_multihost.py's shared file: 128 x 12 labelled rows
    (RandomState(11)); returns the rows."""
    rng = np.random.RandomState(11)
    pts = rng.randn(128, 12).astype(np.float32)
    labs = rng.randint(1, 4, 128)
    with open(path, "w") as f:
        f.write("12\n")
        for row, lab in zip(pts, labs):
            f.write(" ".join(f"{v:.6f}" for v in row) + f" L{lab}\n")
    return pts


def multihost_phase(smi, tally):
    """Two torchrun "hosts" on this machine (--nnodes 2 --nproc-per-node 2,
    node ranks 0 and 1, one rendezvous on 127.0.0.1; CUDA_VISIBLE_DEVICES
    0,1 and 2,3, so each host sees its own two cards): four ranks of
    `python -m som_lvq_pak_torch.dryrun multihost`, which start the world
    with initialize_distributed() and no arguments (NCCL, cuda:LOCAL_RANK).
    Their arrays against the one-device port on the card: the SOM step
    against som_batch_step and the olvq1 step against olvq1_batch_step at
    1e-5 (the alphas 1e-6), the rows interleaved as the file's; the
    workers hold the resume, the fused TP and the mixed steps themselves."""
    import socket
    import tempfile

    import torch

    from som_lvq_pak_torch.models.fast import olvq1_batch_step, som_batch_step

    with tempfile.TemporaryDirectory(prefix="somvq_mh_") as tmp:
        pts = multihost_data(os.path.join(tmp, "mh.dat"))
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
        s.close()
        procs = []
        t0 = time.perf_counter()
        for host, cards in ((0, "0,1"), (1, "2,3")):
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
                 "--nproc-per-node", "2", "--node-rank", str(host), "--master-addr",
                 "127.0.0.1", "--master-port", port, "-m", "som_lvq_pak_torch.dryrun",
                 "multihost", os.path.join(tmp, "mh.dat"), tmp],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MESH_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        world_s = time.perf_counter() - t0
        for p, out in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"multihost: a torchrun host failed:\n{out[-4000:]}")
        ranks = sorted((json.loads(line) for out in outs for line in out.splitlines()
                        if line.startswith('{"multihost_rank"')),
                       key=lambda r: r["multihost_rank"])
        data = dict(np.load(os.path.join(tmp, "result.npz")))
    if len(ranks) != 4 or any(r["backend"] != "nccl" for r in ranks):
        raise AssertionError(f"multihost: expected 4 NCCL ranks, got {ranks}")
    for r in ranks:
        idle = [k for k in ("dist_argmin", "segment_sum", "som_fused_train_step",
                            "som_neighborhood_accumulate", "som_blend_winner")
                if r["launches"][k] == 0]
        if idle:
            raise AssertionError(f"multihost: rank {r['multihost_rank']} never launched {idle}")
        tally(r["launches"])
    dev = "cuda"
    T = lambda a: torch.from_numpy(a.copy()).to(dev)  # noqa: E731  (steps write in place)
    som = som_batch_step(T(data["codes"]), T(data["xb"]), 16, True, 0.05, 3.0,
                         gaussian=False).cpu().numpy()
    oc, oa = olvq1_batch_step(T(data["codes"]), T(data["clabels"]),
                              torch.full((64,), 0.3, device=dev), T(data["xb"]),
                              T(data["xl"]))
    diffs = dict(som=float(np.abs(data["som"] - som).max()),
                 olvq1=float(np.abs(data["lvq_codes"] - oc.cpu().numpy()).max()),
                 alphas=float(np.abs(data["lvq_alphas"] - oa.cpu().numpy()).max()))
    np.testing.assert_allclose(data["som"], som, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(data["lvq_codes"], oc.cpu().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(data["lvq_alphas"], oa.cpu().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(data["xb"], np.concatenate([pts[0::2], pts[1::2]]),
                               rtol=1e-5, atol=1e-5)
    emit("e2e_mesh_multihost_2x2", card=smi, world_s=world_s,
         ranks=[{k: r[k] for k in ("multihost_rank", "host", "backend", "device", "layout")}
                for r in ranks],
         launches_per_rank=[{k: n for k, n in r["launches"].items() if n} for r in ranks],
         max_abs_diff_from_one_device=diffs,
         gate=("4 NCCL ranks from torchrun's environment; SOM and olvq1 steps within "
               "1e-5 (alphas 1e-6) of the one-device steps; resume bit-equal, fused TP "
               "within 1e-5 and mixed within 1e-4 of one-device K3 with equal winners "
               "(in the workers)"))


def four_card_phases(smi, tally):
    """What --mesh adds on a host with four cards: the two torchrun hosts.
    With fewer cards one line says what did not run and why."""
    import torch

    cards = torch.cuda.device_count()
    if cards < 4:
        emit("four_card_runs_not_run", card=smi, cards=cards,
             not_run=["phases 18-19 over NCCL, one card per rank",
                      "e2e_mesh_multihost_2x2: two torchrun hosts of two ranks"],
             why=f"{cards} card(s) here; these need 4 (one per rank; each host "
                 "must see a card per rank)")
        return
    multihost_phase(smi, tally)


def state_probe(smi):
    """--state: what the kernel phases of option_phases leave behind for a
    small e2e cell.  e2e_masked_64x64_100k (phase 7) runs five times fresh,
    five times after option_phases, five after release(), and five after
    20 s idle; each reading carries the five train_s, the caching
    allocator's reserved and allocated GiB, and the card's SM clock,
    temperature and power draw."""
    import torch

    X = blob_data(42, 100_000, 4)
    Xm, mask, rng = masked_data(X, 43, 16384, every_other=True)
    weight = rng.uniform(0.5, 2.0, size=X.shape[0]).astype(np.float32)

    def reading():
        t = [e2e(Xm, 64, 512, 16, 16384, mask=mask, weight=weight)[1] for _ in range(5)]
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        return dict(train_s=t, median_train_s=sorted(t)[2],
                    reserved_gib=torch.cuda.memory_reserved() / 2 ** 30,
                    allocated_gib=torch.cuda.memory_allocated() / 2 ** 30, card=card)

    out = dict(fresh=reading())
    option_phases({})
    out["after_phases"] = reading()
    release()
    out["released"] = reading()
    time.sleep(20)
    out["rested"] = reading()
    emit("state", card=smi, cell="e2e_masked_64x64_100k", **out)


class SassDump:
    """cuobjdump --dump-sass of the built library in a process of its own,
    its text into a temporary file beside the library; `check` waits for it and emits the
    "sass" line: the tensor-core instructions of each kernel family, each
    held to its rule (sass_mma, sass_none, no_dp4a).  The process is killed
    when the script exits before the check."""

    def __init__(self, library: str):
        import tempfile

        from som_lvq_pak_torch import _build
        from som_lvq_pak_torch.tools.sass_diff import dump_command

        self.out = tempfile.TemporaryFile(mode="w+", dir=_build.BUILD_DIR)
        self.proc = subprocess.Popen(dump_command(library), stdout=self.out,
                                     stderr=subprocess.PIPE, text=True)
        self.checked = False
        atexit.register(self.close)

    def check(self) -> None:
        from som_lvq_pak_torch.tools.sass_diff import parse

        if self.checked:
            return
        err = self.proc.communicate()[1]
        if self.proc.returncode != 0:
            raise RuntimeError(f"cuobjdump failed ({self.proc.returncode}): {err}")
        self.out.seek(0)
        dump = parse(self.out.read())
        emit("sass", hmma_per_function=sass_mma(dump),
             hgmma_per_function=sass_mma(dump, TF32_WGMMA_KERNELS, "HGMMA"),
             hmma_in_tf32_wgmma=sass_none(dump, TF32_WGMMA_KERNELS, "HMMA"),
             imma_per_function=sass_mma(dump, INT8_MMA_KERNELS, "IMMA"),
             igmma_per_function=sass_mma(dump, INT8_WGMMA_KERNELS, "IGMMA"),
             utmaldg_per_function=sass_mma(dump, TMA_KERNELS, "UTMALDG"),
             idp4a=no_dp4a(dump))
        self.checked = True

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if sys.argv[1:] not in ([], ["--profile"], ["--mesh"], ["--state"]):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA device", file=sys.stderr)
        return 1
    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.data import native_io
    from som_lvq_pak_torch.models.som import find_qerror
    from som_lvq_pak_torch.ops.dist_argmin import (dist_argmin, dist_argmin_masked,
                                                   dist_argmin_masked_plain,
                                                   dist_argmin_plain, dist_argmin_t,
                                                   dist_argmin_t_plain)
    from som_lvq_pak_torch.ops.dist_top2 import (dist_top2, dist_top2_masked,
                                                 dist_top2_plain)
    from som_lvq_pak_torch.ops import som_step
    from som_lvq_pak_torch.ops.distance import fp32_matmul
    from som_lvq_pak_torch.models.trainer import fused_step_choice
    from som_lvq_pak_torch.ops.som_step import (
        som_fused_factored_step, som_fused_factored_step_plain, som_fused_train_step,
        som_fused_train_step_plain)
    from som_lvq_pak_torch.ops.som_update import (
        som_neighborhood_update_idx, som_neighborhood_update_idx_masked,
        som_neighborhood_update_idx_plain)
    from som_lvq_pak_torch.tools import int8_probe, int8_step_ab

    fp32_matmul()  # plain references in full float32 (no TF32)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         card=smi, python=sys.version.split()[0])

    t0 = time.perf_counter()
    built_now = not os.path.exists(_build.library_path())
    _build.build(verbose=True)  # prints the log, ptxas's report with it
    _build.library()
    slowest = sorted(_build.compile_seconds().items(), key=lambda kv: -kv[1])[:3]
    build_s = time.perf_counter() - t0
    # the native data-file engine (native/somvq_io.cpp, g++), which the I/O
    # phases require
    t0 = time.perf_counter()
    engine_built_now = not os.path.exists(native_io.library_path())
    require_engine()
    emit("build", seconds=build_s, library=_build.library_path(),
         built_now=built_now, slowest_nvcc=slowest,
         engine_seconds=time.perf_counter() - t0, engine_library=native_io.library_path(),
         engine_built_now=engine_built_now)
    # the report of the build that made this library, this run's or an
    # earlier one's (built_now says which); empty if that build kept no log
    ptxas = ptxas_report(_build.build_log())
    emit("ptxas", card=smi, built_now=built_now, report=ptxas)
    clean_ptxas(ptxas)
    # the library's SASS dump takes minutes of one CPU core and no card: it
    # runs beside the phases (the other modes wait for it here), and its
    # checks come before the run's result
    sass_dump = SassDump(_build.library_path())
    if sys.argv[1:]:
        sass_dump.check()
    if sys.argv[1:] == ["--profile"]:
        profile_cells()
        print(smi)
        return 0
    if sys.argv[1:] == ["--state"]:
        state_probe(smi)
        print(smi)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        # phases 14-19 alone, with phase 6's single-device run for their
        # gate; on a host with as many cards as ranks the worlds run NCCL
        Xm, mask, weight = masked_stream_data()
        q_masked128 = main_path(
            "e2e_masked_128x128_100k",
            lambda: e2e(Xm, 128, 1024, 32, 8192, mask=mask, weight=weight)[0],
            ("dist_argmin", "som_fused_factored_step", "dist_argmin_masked"))[0]
        mesh_phases(smi, lambda got: None, q_masked128)
        mesh_dryrun_phase(smi, lambda got: None)
        mesh_overlap_phase(smi, lambda got: None)
        four_card_phases(smi, lambda got: None)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- kernels against their plain versions ----------------------------
    # each kernel's record is taken at its main-path shape (rs[0]), with the
    # largest error over all its shapes
    recs = {}
    # K1's and K2's prologue at the 65,536-code codebooks first (its record),
    # the online scan's 4096, then D 5, 37 and 130 (three 64-feature slabs
    # of ||m||^2), each bit-equal to its plain version
    rs = [phase_split_codes(N, D, seed=80 + D)
          for N, D in ((65536, 64), (4096, 64), (999, 5), (3001, 37), (2999, 130))]
    recs["split_codes"] = rs[0]
    # K1, K2 and K4 run every shape twice (bit-equal), K1 also bit-equal to
    # K2 on the same inputs (one kernel body); K2 also at a StreamingReader
    # chunk of 16384 rows; K1's, K2's and K4's records carry library_ms
    for name, k, p, mask_p, lib in (
            ("dist_argmin", dist_argmin, dist_argmin_plain, None, "min"),
            ("dist_argmin_t", dist_argmin_t, dist_argmin_t_plain, None, "max"),
            ("dist_argmin_masked", dist_argmin_masked, dist_argmin_masked_plain, 0.1,
             "min")):
        kw = dict(mask_p=mask_p, rerun=True,
                  twin=dist_argmin_t if k is dist_argmin else None)
        rs = [phase_distance(name, k, p, 4096, 65536, 64, seed=1, library=lib, **kw),
              phase_distance(name, k, p, 1000, 999, 5, seed=2, **kw),
              phase_distance(name, k, p, 1000, 999, 5, seed=3, dup=True, **kw)]
        if name == "dist_argmin_t":  # the 1M eval's single launch
            rs.insert(0, phase_distance(name, k, p, 1_000_000, 65536, 64,
                                        seed=5, iters=3, library=lib, **kw))
            rs.append(phase_distance(name, k, p, 16384, 65536, 64, seed=39, **kw))
        # K1: the 1M run's prologue; K2: its evaluation; K4: a masked step
        recs[name] = dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
    # K1 at the LVQ step's batch (8 CTAs of 128 samples, 33 splits on an
    # H100), a mesh rank's step (B 512 x 32768), the LVQ accuracy's one
    # launch over the 1M data, D 37 and D 130 (three 64-feature slabs); each
    # run twice and beside K2.  K1 and K4 at the masked LVQ cell's step
    # (B 1024 against 4096 codes: K1 8 splits of four 128-code tiles, K4 8
    # of eight 64-code tiles)
    k1_kw = dict(rerun=True, twin=dist_argmin_t)
    k1_ms = {}
    for shape, seed, iters in (((1024, 65536, 64), 9, 10), ((512, 32768, 64), 17, 10),
                               ((1_000_000, 65536, 64), 14, 3), ((777, 3001, 37), 47, 10),
                               ((1000, 2999, 130), 48, 10)):
        r = phase_distance("dist_argmin", dist_argmin, dist_argmin_plain, *shape, seed=seed,
                           iters=iters, **k1_kw)
        k1_ms[shape] = r["ms"]
        recs["dist_argmin"]["max_abs_err"] = max(recs["dist_argmin"]["max_abs_err"],
                                                 r["max_abs_err"])
    # the prologue's share of K1's call (its kernel runs inside every K1 and
    # K2 call) at the LVQ step's B 1024 and at B 4096, by its launch_ms
    pro = recs["split_codes"]
    emit("k1_prologue", card=smi, prologue_ms=pro["ms"], prologue_launch_ms=pro["launch_ms"],
         k1_b1024_ms=k1_ms[(1024, 65536, 64)], k1_b4096_ms=recs["dist_argmin"]["ms"],
         share_b1024=pro["launch_ms"] / k1_ms[(1024, 65536, 64)],
         share_b4096=pro["launch_ms"] / recs["dist_argmin"]["ms"])
    for name, k, p, mask_p in (
            ("dist_argmin", dist_argmin, dist_argmin_plain, None),
            ("dist_argmin_masked", dist_argmin_masked, dist_argmin_masked_plain, 0.1)):
        r = phase_distance(name, k, p, 1024, 4096, 64, seed=15, mask_p=mask_p,
                           **(k1_kw if mask_p is None else dict(rerun=True)))
        recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], r["max_abs_err"])
    # K1 and K4 at the online scan's step, one sample against a 64x64 map
    # (B 1 x 4096 x 64; K4 with no row masked entirely), each run twice and
    # K1 beside K2
    for name, k, p, mask_p in (
            ("dist_argmin", dist_argmin, dist_argmin_plain, None),
            ("dist_argmin_masked", dist_argmin_masked, dist_argmin_masked_plain, 0.1)):
        r = phase_distance(name, k, p, 1, 4096, 64, seed=71, mask_p=mask_p,
                           full_rows=False, **(k1_kw if mask_p is None else dict(rerun=True)))
        recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"], r["max_abs_err"])
    # K4 with the one sample fully masked (the masked LVQ scans' trap: index
    # 0, value 0)
    phase_distance("dist_argmin_masked", dist_argmin_masked, dist_argmin_masked_plain, 1,
                   4096, 64, seed=72, mask_p=0.1, rerun=True)
    # K4 at a ragged D and at D 130 (three 64-feature slabs, the A and keep
    # fragments reloaded per slab), each run twice
    for shape, seed in (((777, 3001, 37), 51), ((1000, 2999, 130), 52)):
        r = phase_distance("dist_argmin_masked", dist_argmin_masked,
                           dist_argmin_masked_plain, *shape, seed=seed, mask_p=0.1,
                           rerun=True)
        recs["dist_argmin_masked"]["max_abs_err"] = max(
            recs["dist_argmin_masked"]["max_abs_err"], r["max_abs_err"])
    # K4's prologue alone at the 65,536-code codebook (its times into K4's
    # record), then D 5, 37 and 130, each bit-equal to its plain version
    rs = [phase_split_codes(N, D, seed=90 + D, masked=True)
          for N, D in ((65536, 64), (999, 5), (3001, 37), (2999, 130))]
    recs["dist_argmin_masked"].update(prologue_ms=rs[0]["ms"],
                                      prologue_launch_ms=rs[0]["launch_ms"])
    # K1 on two shards of the codebook against the whole: the sharded winner
    phase_k1_shards(4096, 65536, 64, 30001, seed=49)
    phase_k1_shards(512, 32768, 64, 16411, seed=50)
    # K8 and K9 at the LVQ step's shape first (their record, with
    # library_ms), then the masked LVQ cell's step (B 1024 x 4096), small,
    # exact-tie and two-code shapes, a ragged D 37 and D 130 (three
    # 64-feature slabs), every shape run twice (bit-equal) and beside the
    # walk's argmin (K1 for K8, K4 for K9: the best pair bit for bit; the
    # masked dist_argmin is K4), K8's pairs also K10's at k 2; last the
    # per-sample lvq2/lvq3 scans' step (B 1 x 4096: K9's one row partly
    # masked, then fully masked)
    for name, k, mask_p in (("dist_top2", dist_top2, None),
                            ("dist_top2_masked", dist_top2_masked, 0.1)):
        cases = (((1024, 65536, 64), 10, False, True), ((1024, 4096, 64), 16, False, True),
                 ((1000, 999, 5), 11, False, True), ((1000, 999, 5), 12, True, True),
                 ((1000, 2, 5), 13, False, True), ((777, 3001, 37), 59, False, True),
                 ((1000, 2999, 130), 60, False, True), ((1, 4096, 64), 73, False, False))
        if mask_p is not None:
            cases += (((1, 4096, 64), 74, False, True),)
        rs = [phase_top2(name, k, dist_top2_plain, *shape, seed=seed, dup=dup,
                         mask_p=mask_p, library=j == 0, twin=dist_argmin,
                         full_rows=full, topk_twin=mask_p is None)
              for j, (shape, seed, dup, full) in enumerate(cases)]
        recs[name] = dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
    # the LVQ steps' segment sum (not a TPU kernel: its own line at the end)
    # at the olvq1 step's B 1024 x D 64 into 65,536 codes first (its record),
    # its update with the two hit counts as columns (66), the masked LVQ
    # cell's 4096 codes, a hit count alone, a hot segment and a batch past
    # the one-CTA sort (torch.sort then)
    rs = [phase_segment_sum(B, C, noc, seed=seed, kind=kind)
          for B, C, noc, seed, kind in ((1024, 64, 65536, 53, "spread"),
                                        (1024, 66, 65536, 54, "spread"),
                                        (1024, 64, 4096, 55, "spread"),
                                        (1024, None, 65536, 56, "spread"),
                                        (4096, 64, 4096, 57, "hot"),
                                        (8192, 64, 65536, 58, "spread"))]
    seg_rec = dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
    # K3 (factored=False: these geometries but 12x8 take K13 by default) at
    # the 1M cell's step first (its record), then D 5, a ragged map, D 200
    # (64-row CTAs past D 128), K13's shapes (64x64 B 512, 256x256 B 1024,
    # 64x64 bubble B 4096) and a bf16 codebook; every case run twice
    # (bit-equal), with its split-TF32 bound
    k3 = lambda *a, **kw: som_fused_train_step(*a, factored=False, **kw)  # noqa: E731
    k3_kw = dict(twin={}, tf32x3=True)
    steps = [phase_step(k3, som_fused_train_step_plain, *case, seed=4, **k3_kw)
             for case in ((256, 256, True, True, 4096, 64, 64.0),
                          (128, 128, True, True, 1024, 64, 32.0),
                          (12, 8, False, False, 1024, 64, 3.0),
                          (12, 8, True, False, 1000, 5, 3.0),
                          (10, 6, True, True, 100, 37, 3.0),
                          (16, 16, False, True, 256, 200, 4.0),
                          (64, 64, True, True, 512, 64, 16.0),
                          (256, 256, True, True, 1024, 64, 64.0),
                          (64, 64, True, False, 4096, 64, 16.0))]
    phase_step(k3, som_fused_train_step_plain, 256, 256, True, True, 4096, 64, 64.0,
               seed=4, bf16=True, win_rel=1e-2, **k3_kw)
    # the records' max_abs_err: float32 shapes (a bf16 codebook is held to one
    # bf16 ulp, bf16_ulp_close)
    recs["som_fused_train_step"] = dict(
        steps[0], max_abs_err=max(r["max_abs_err"] for r in steps))
    recs_k3 = steps
    # K13 at e2e_128x128_100k's step first (its record), then 256x256 at
    # B 1024, 64x64 bubble at B 4096 (64-row CTAs), a rect map,
    # e2e_64x64_1M_stepwise's step, every code three times (exact ties), K3's
    # D 5 (8-wide split rows), ragged D 37 and D 200 (4 warps, the tightest
    # shared memory) cases and a bf16 codebook; every case run twice
    # (bit-equal), with its split-TF32 bound
    f32_tols = dict(codes_tol=1e-5, val_tol=(1e-4, 1e-4), twin={}, tf32x3=True,
                    separable=True)
    k13_cases = (((128, 128, True, True, 1024, 64, 32.0), 40, False),
                 ((256, 256, True, True, 1024, 64, 64.0), 41, False),
                 ((64, 64, True, False, 4096, 64, 16.0), 42, False),
                 ((128, 64, False, True, 1024, 64, 20.0), 43, False),
                 ((64, 64, True, True, 512, 64, 16.0), 44, False),
                 ((48, 16, True, True, 1024, 64, 8.0), 45, True),
                 ((12, 8, True, False, 1000, 5, 3.0), 47, False),
                 ((10, 6, True, True, 100, 37, 3.0), 48, False),
                 ((16, 16, False, True, 256, 200, 4.0), 49, False),
                 ((64, 64, True, True, 4096, 64, 16.0), 50, False))
    steps = [phase_step(som_fused_factored_step, som_fused_factored_step_plain, *case,
                        seed=seed, name="som_fused_factored_step", dup=dup, **f32_tols)
             for case, seed, dup in k13_cases]
    k13_by_case = {case: r for (case, _, _), r in zip(k13_cases, steps)}
    phase_step(som_fused_factored_step, som_fused_factored_step_plain, 128, 128, True,
               True, 1024, 64, 32.0, seed=46, name="som_fused_factored_step", bf16=True,
               val_tol=(1e-4, 1e-4), win_rel=1e-2, twin={}, tf32x3=True)
    recs["som_fused_factored_step"] = dict(
        steps[0], max_abs_err=max(r["max_abs_err"] for r in steps))
    # K13 beside K3 at every shape both ran at: K13's two main-path shapes,
    # 256x256 at B 1024, 64x64 bubble at B 4096 (the rows of the JAX
    # trainer's choice that take K13), D 5, D 37 and D 200, both timed in
    # this run
    k3_by_shape = {(tuple(r["shape"]), r["kernel"].split()[-1]): r for r in recs_k3}
    for r13 in steps:
        r3 = k3_by_shape.get((tuple(r13["shape"]), r13["kernel"].split()[-1]))
        if r3 is None:
            continue
        emit("k13_vs_k3", card=smi, shape=r13["shape"], k13_ms=r13["ms"], k3_ms=r3["ms"],
             k13_over_k3=r13["ms"] / r3["ms"], k13_route_pct=r13["route_pct"],
             k3_route_pct=r3["route_pct"])
    # K14 at K14_CASES (e2e_64x64_1M_B4096's step first: its record), each
    # run twice (bit-equal), with its route's bound, at the cluster the
    # wrapper picks; the 64x64 cases (a bf16 codebook too), the trainer's
    # other K14 maps and 128x128 also at every cluster size, each held to the same gates (one
    # "k14_cluster" line each: the ms and route share at each size, the
    # pick), the 64x64 cases beside K13 at the same shape (one "k14_vs_k13"
    # line each); then its options stagger and int8_win (held to the main
    # form at a cluster of one), K15-K17 and the attainable_pct lines
    steps = [k14_step(case, seed, kw) for case, seed, kw in K14_CASES]
    k14_step(*K14_BF16_CODEBOOK, K14_BOTH, bf16=True)
    recs["som_fused_factored_chunked_step"] = dict(
        steps[0], max_abs_err=max(r["max_abs_err"] for r in steps))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cluster_cases = ([(case, seed, kw, False, r14)
                      for (case, seed, kw), r14 in zip(K14_CASES, steps)
                      if case[:2] == (64, 64)]
                     + [(*K14_BF16_CODEBOOK, K14_BOTH, True, None)]
                     + [(case, seed, kw, False, None) for case, seed, kw in K14_CLUSTER_CASES])
    for case, seed, kw, bf16, r14 in cluster_cases:
        by_c, memo = {}, {}  # the plain version run and timed once a case
        for c in som_step.K14_CLUSTERS:
            with k14_cluster_forced(c):
                by_c[c] = k14_step(case, seed, kw, bf16=bf16,
                                   name=f"som_fused_factored_chunked_step cluster={c}",
                                   plain_memo=memo)
        pick = som_step._k14_cluster_on(case[0] * case[1], case[5],
                                        bool(kw.get("batch_bf16")), sms)
        emit("k14_cluster", card=smi, shape=by_c[1]["shape"], options=kw,
             gaussian=case[3], bf16_codebook=bf16, ms={c: r["ms"] for c, r in by_c.items()},
             route_pct={c: r["route_pct"] for c, r in by_c.items()},
             route_bound_ms=by_c[1]["route_bound_ms"], cluster_chosen=pick,
             chosen_ms=by_c[pick]["ms"], c1_over_chosen=by_c[1]["ms"] / by_c[pick]["ms"])
        if r14 is not None:
            r13 = k13_by_case[case]
            emit("k14_vs_k13", card=smi, shape=r14["shape"], options=kw, gaussian=case[3],
                 k14_ms=r14["ms"], k13_ms=r13["ms"], k14_over_k13=r14["ms"] / r13["ms"],
                 k14_route_pct=r14["route_pct"], k13_route_pct=r13["route_pct"])
    sk = option_phases(recs)
    release()
    for fused, step, skel in (
            ("K14 256x256 B 4096, bf16 x-pattern", steps[1], sk[0]),
            ("K14 256x256 B 8192, bf16 x-pattern and batches", steps[2], sk[1]),
            ("K3 256x256 B 4096, e2e_256x256_1M's step", recs["som_fused_train_step"],
             sk[0])):
        emit("attainable_pct", card=smi, fused=fused, fused_ms=step["ms"],
             skeleton=skel["kernel"], skeleton_ms=skel["ms"],
             attainable_pct=100.0 * skel["ms"] / step["ms"])
    phase_bubble_boundary()
    # K5 and K6 at the masked 1M cell's step first (their records), the
    # 128x128 step, a small rect bubble map, D 5, a ragged map at D 37 and
    # D 200 (K6: four 64-feature slabs)
    update_cases = ((256, 256, True, True, 4096, 64, 64.0),
                    (128, 128, True, True, 1024, 64, 32.0),
                    (12, 8, False, False, 1024, 64, 3.0),
                    (12, 8, True, False, 1000, 5, 3.0),
                    (10, 6, True, True, 100, 37, 3.0),
                    (16, 16, False, True, 256, 200, 4.0))
    for k, p in ((som_neighborhood_update_idx, som_neighborhood_update_idx_plain),
                 (som_neighborhood_update_idx_masked,
                  lambda c, x, b, m, *a: som_neighborhood_update_idx_plain(
                      c, x, b, *a, mask=m))):
        masked = k is som_neighborhood_update_idx_masked
        rs = [phase_update(k, p, *case, seed=6, masked=masked) for case in update_cases]
        recs[k.__name__] = dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
    phase_update_bubble_boundary()
    # K7: e2e_64x64_1M's group shape first (its record, with K13's chain and
    # every CTA height), then bench.py:prep_vmem_steps,
    # bench.py:prep_somexample_shape, a ragged shape (99 rows, D 37) with
    # every code three times, and the largest codebook the grouped path
    # takes (128x64 at D 128, 4 MB; every height).  At radius 16 the first
    # keeps alpha small enough that no unit's weight mass reaches 1:
    # saturated units blend to nearly equal rows, whose near-tie winners the
    # kernel's and the plain version's summation orders decide differently,
    # and such flips compound over 32 steps
    rs = [phase_vmem(64, 64, True, True, 64, 512, 32, 16.0, 0.001, seed=7, varied=True,
                     k13=True, rows=True),
          phase_vmem(64, 64, True, True, 128, 512, 32, 3.0, 0.02, seed=5),
          phase_vmem(12, 8, True, False, 5, 128, 64, 3.0, 0.02, seed=6),
          phase_vmem(11, 9, False, True, 37, 100, 9, 2.5, 0.05, seed=8, varied=True,
                     dup=True),
          phase_vmem(128, 64, True, True, 128, 512, 32, 6.0, 0.01, seed=61, rows=True)]
    # K7 at 1024, 4096 and 16384 rows (32x32, 64x64, 128x128; K 8, B 256)
    # at D 5, 64 and 128 (the walk, every cluster size) and D 129 (the
    # mma.sync kernel, every height; not at 16384 rows, which no height of
    # it holds resident: it raises there, as before the walk)
    rs += [phase_vmem(side, side, True, True, D, 256, 8, 4.0, 0.005, seed=62 + j,
                      varied=True, rows=True)
           for j, (side, D) in enumerate((side, D) for side in (32, 64, 128)
                                         for D in (5, 64, 128, 129)
                                         if not (side == 128 and D == 129))]
    recs["som_vmem_train_steps"] = dict(rs[0], max_abs_err=max(r["max_abs_err"]
                                                               for r in rs))
    # K10 at the sharded lvq3 step's shape (B 1024 over (data 2, model 2) is
    # 512 per rank against a 32768-row shard; their record, with library_ms,
    # timed over 50 back-to-back launches: that shape reads the host's floor),
    # the whole batch against the shard, K8's shapes at k = 2 (the LVQ step,
    # the masked LVQ cell's, D 37, D 130, N = 2, 1000 x 999 x 5), the rank's
    # shape at k = 4, 8 and 16 (each list width KM), small shapes at k = 1,
    # 3, 5 and 16, every code twice (at D 5, 37, 130 and 300), N = 17 at
    # k = 16, D 130 at k = 16 and D 300 at k = 8: every list width at D 5,
    # 37, 64, 130 and 300, N mostly not a multiple of the walk's 128-code
    # tile
    cases = (((512, 32768, 64), 2, 18, False), ((1024, 32768, 64), 2, 19, False),
             ((1024, 65536, 64), 2, 61, False), ((1024, 4096, 64), 2, 62, False),
             ((777, 3001, 37), 2, 63, False), ((1000, 2999, 130), 2, 64, False),
             ((1000, 2, 5), 2, 65, False), ((1000, 999, 5), 2, 70, False),
             ((512, 32768, 64), 4, 66, False),
             ((512, 32768, 64), 8, 67, False), ((512, 32768, 64), 16, 68, False),
             ((1000, 999, 5), 1, 20, False), ((1000, 999, 5), 3, 26, False),
             ((1000, 999, 5), 5, 21, False),
             ((1000, 999, 5), 16, 22, False), ((1000, 998, 5), 2, 23, True),
             ((1000, 998, 5), 16, 24, True), ((1000, 17, 5), 16, 25, False),
             ((1000, 2999, 130), 16, 69, False), ((778, 3002, 37), 8, 74, True),
             ((1000, 3000, 130), 5, 75, True), ((600, 1201, 300), 8, 76, False),
             ((600, 1202, 300), 3, 77, True))
    rs = [phase_topk(*shape, k, seed=seed, dup=dup, library=j == 0,
                     iters=50 if j == 0 else 10)
          for j, (shape, k, seed, dup) in enumerate(cases)]
    recs["dist_topk"] = dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
    # K10 in the reference tie order (the host tools' kNN route), at the LVQ
    # step's shape with k 5, and with every code twice
    for dup, seed in ((False, 72), (True, 73)):
        phase_topk_reference(1024, 65536, 64, 5, seed=seed, dup=dup)
    # each list width KM at the rank's shape, beside its instantiations'
    # registers and spills (D 64: KT 8)
    emit("k10_km", card=smi, shape=[512, 32768, 64],
         ms={r["km"]: r["ms"] for r in rs if r["shape"] == [512, 32768, 64]},
         route_pct={r["km"]: r["route_pct"] for r in rs if r["shape"] == [512, 32768, 64]},
         ptxas={n: v for n, v in ptxas.items() if n.startswith("dist_topk_sm90_kernel<2,")})
    # K11 at the mixed mesh step's shard (rows 32768.. of the 256x256 map,
    # B 4096 over a data axis of 2; their record first)
    rs = [phase_accum(256, hexa, gaussian, 32768, 32768, 2048, 64, radius, per_sample,
                      seed=seed)
          for hexa, gaussian, radius, per_sample, seed in (
              (True, True, 64.0, False, 26), (True, True, 64.0, True, 27),
              (False, False, 20.0, True, 28), (True, False, 20.0, False, 29),
              (False, True, 8.0, False, 30))]
    recs["som_neighborhood_accumulate"] = dict(
        rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
    rs = [phase_blend(32768, 64, 2048, seed=31), phase_blend(32768, 64, 4096, seed=32),
          phase_blend(32768, 64, 2048, seed=33, dup=True),
          phase_blend(1000, 5, 999, seed=34), phase_blend(1000, 128, 777, seed=37),
          phase_blend(500, 129, 300, seed=38)]
    recs["som_blend_winner"] = dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
    # K3 with a unit offset on each half of the 256x256 map; K11 + K12 on one
    phase_shard_step(256, True, True, 4096, 64, 64.0, seed=35)
    phase_shard_step(16, False, False, 1024, 64, 3.0, seed=36)
    phase_shard_step(16, True, False, 1024, 128, 3.0, seed=39)
    # every SOM step kernel past 256 features (the feature passes)
    wide_d_phases(recs)

    launches = {fn.__name__: 0 for fn in counted()}

    def tally(got):
        for name, n in got.items():
            launches[name] += n

    # ---- e2e 128x128, 100k x 64 (bench.py:run_e2e_config4) ---------------
    # e2e() runs a 2-batch warm-up fit + eval before the timed run; the
    # counts cover both, all of them through the main path's entry points
    X = blob_data(42, 100_000, 4)
    k128 = {}
    (q, train_s, eval_s), (q_plain, train_plain_s, eval_plain_s), got = main_path(
        "e2e_128x128_100k", lambda: e2e(X, 128, 1024, 32, 8192, keep=k128),
        ("dist_argmin", "dist_argmin_t", "som_fused_factored_step"),
        lambda: e2e(X, 128, 1024, 32, 8192))
    tally(got)
    if got["som_fused_train_step"]:
        raise AssertionError("e2e 128: K3 launched where the JAX trainer takes the "
                             "separable kernel")
    check_e2e("e2e 128", q, q_plain, 0.005)
    if abs(q - ANCHOR_128) > 0.02 * ANCHOR_128:
        raise AssertionError(f"e2e 128: qerror {q} vs JAX anchor {ANCHOR_128} (> 2%)")
    # the same cell with a bf16-resident codebook: K13 reads and writes bf16
    # rows; the JAX gate (tests/test_trainer_quality.py:424-437): qerror
    # under 1.1x the float32 run's
    (q16, train16_s, _), _, got16 = main_path(
        "e2e_128x128_100k bf16", lambda: e2e(X, 128, 1024, 32, 8192, bf16=True),
        ("dist_argmin", "dist_argmin_t", "som_fused_factored_step"))
    tally(got16)
    if not (np.isfinite(q16) and q16 < 1.1 * q):
        raise AssertionError(f"e2e 128 bf16: qerror {q16} not under 1.1 x {q}")
    emit("e2e_128x128_100k", card=smi, qerror_per_sample=q, train_s=train_s,
         qerror_eval_s=eval_s, plain_qerror_per_sample=q_plain,
         plain_train_s=train_plain_s, plain_qerror_eval_s=eval_plain_s,
         kernel_choice=fused_step_choice(128 * 128, 128, True, True, 1024, 64),
         launches=got, bf16_qerror_per_sample=q16, bf16_train_s=train16_s,
         bf16_launches=got16,
         gate="qerror within 0.5% of plain and 2% of the JAX anchor; bf16 run under "
              "1.1x the float32 run's; no K3 launch")

    # ---- e2e_wide_128x128_D512: 100k x 512 (a user clustering 512-wide
    # embeddings; 205 MB on the device): SOMTrainer.fit on the JAX trainer's
    # choice, K13 at D 512 in its feature passes, then find_qerror(fast), K2
    # at D 512; quality within 1% of the plain run and below the random init's
    Xw = blob_data(44, 100_000, 4, dim=512)
    (qw, trainw_s, evalw_s), (qw_plain, trainw_plain_s, evalw_plain_s), gotw = main_path(
        "e2e_wide_128x128_D512", lambda: e2e(Xw, 128, 1024, 32, 8192),
        ("dist_argmin", "dist_argmin_t", "som_fused_factored_step"),
        lambda: e2e(Xw, 128, 1024, 32, 8192))
    tally(gotw)
    if gotw["som_fused_train_step"]:
        raise AssertionError("e2e wide: K3 launched where the JAX trainer takes the "
                             "separable kernel")
    check_e2e("e2e wide", qw, qw_plain, 0.01)
    Xw_dev = torch.from_numpy(Xw).to("cuda")
    qw_init = find_qerror(random_codes(Xw, 128), Xw_dev) / Xw.shape[0]
    if not qw < qw_init:
        raise AssertionError(f"e2e wide: qerror {qw} not below the random init's {qw_init}")
    emit("e2e_wide_128x128_D512", card=smi, qerror_per_sample=qw, train_s=trainw_s,
         qerror_eval_s=evalw_s, plain_qerror_per_sample=qw_plain,
         plain_train_s=trainw_plain_s, plain_qerror_eval_s=evalw_plain_s,
         random_init_qerror_per_sample=qw_init, data_mb=Xw.nbytes / 1e6,
         kernel_choice=fused_step_choice(128 * 128, 128, True, True, 1024, 512),
         launches=gotw,
         gate="qerror within 1% of plain and below the random init's; no K3 launch")
    del Xw, Xw_dev

    # ---- unmasked two-kernel steps through som_batch_step ----------------
    Mk, Mp, got = main_path(
        "som_batch_step_128x128", lambda: som_batch_steps(X, 128, 1024, 8),
        ("dist_argmin", "som_neighborhood_update_idx"),
        lambda: som_batch_steps(X, 128, 1024, 8))
    tally(got)
    X_dev = torch.from_numpy(X).to("cuda")
    q, q_plain = (find_qerror(M, X_dev) / X.shape[0] for M in (Mk, Mp))
    check_e2e("som_batch_step 128", q, q_plain)
    emit("som_batch_step_128x128", steps=8, batch=1024, qerror_per_sample=q,
         plain_qerror_per_sample=q_plain,
         max_abs_codebook_diff=float((Mk - Mp).abs().max()), launches=got)
    del X_dev

    # ---- masked e2e 128x128, 100k x 64: every other chunk masked ---------
    Xm, mask, rng = masked_data(X, 43, 8192, every_other=True)
    weight = rng.uniform(0.5, 2.0, size=X.shape[0]).astype(np.float32)
    km128 = {}
    (q_masked128, train_s, eval_s), (q_plain, train_plain_s, eval_plain_s), got = main_path(
        "e2e_masked_128x128_100k",
        lambda: e2e(Xm, 128, 1024, 32, 8192, mask=mask, weight=weight, keep=km128),
        ("dist_argmin", "som_fused_factored_step", "dist_argmin_masked",
         "som_neighborhood_update_idx_masked"),
        lambda: e2e(Xm, 128, 1024, 32, 8192, mask=mask, weight=weight))
    tally(got)
    check_e2e("e2e masked 128", q_masked128, q_plain)
    emit("e2e_masked_128x128_100k", card=smi, qerror_per_sample=q_masked128,
         train_s=train_s, qerror_eval_s=eval_s, plain_qerror_per_sample=q_plain,
         plain_train_s=train_plain_s, plain_qerror_eval_s=eval_plain_s,
         launches=got)

    # ---- the online scan, som_train_fast and vfind (phases 6a-6c) ---------
    X100, Xm128, mask128 = X, Xm, mask
    som_model_phases(smi, tally, X, Xm, mask)

    # ---- masked e2e 64x64, 100k x 64: grouped, clean and dirty groups ----
    # 16384-row chunks are 32 batches of 512: one group each, masked groups
    # (every step K4 + K6) alternating with clean ones (K1 + one K7 launch)
    Xm, mask, rng = masked_data(X, 43, 16384, every_other=True)
    weight = rng.uniform(0.5, 2.0, size=X.shape[0]).astype(np.float32)
    (q, train_s, eval_s), (q_plain, train_plain_s, eval_plain_s), got = main_path(
        "e2e_masked_64x64_100k",
        lambda: e2e(Xm, 64, 512, 16, 16384, mask=mask, weight=weight),
        ("dist_argmin", "som_vmem_train_steps", "dist_argmin_masked",
         "som_neighborhood_update_idx_masked"),
        lambda: e2e(Xm, 64, 512, 16, 16384, mask=mask, weight=weight))
    tally(got)
    check_e2e("e2e masked 64", q, q_plain)
    emit("e2e_masked_64x64_100k", card=smi, qerror_per_sample=q,
         train_s=train_s, qerror_eval_s=eval_s, plain_qerror_per_sample=q_plain,
         plain_train_s=train_plain_s, plain_qerror_eval_s=eval_plain_s,
         launches=got)

    # ---- e2e 256x256, 1M x 64 (bench.py:run_e2e_1m_65k) ------------------
    X = blob_data(7, 1_000_000, 16)
    k256 = {}
    (q, train_s, eval_s), _, got = main_path(
        "e2e_256x256_1M", lambda: e2e(X, 256, 4096, 64, 16384, keep=k256),
        ("dist_argmin", "dist_argmin_t", "som_fused_train_step"))
    tally(got)
    if abs(q - ANCHOR_1M) > 0.02 * ANCHOR_1M:
        raise AssertionError(f"e2e 1M: qerror {q} vs JAX anchor {ANCHOR_1M} (> 2%)")
    # the same run with the stream shipped as bf16 (tests/test_trainer.py:
    # 359-380): qerror within 1% of the float32-streamed run
    (q16, train16_s, _), _, got16 = main_path(
        "e2e_256x256_1M stream_bf16",
        lambda: e2e(X, 256, 4096, 64, 16384, stream_bf16=True),
        ("dist_argmin", "dist_argmin_t", "som_fused_train_step"))
    tally(got16)
    check_e2e("e2e 1M stream_bf16", q16, q)
    emit("e2e_256x256_1M", card=smi, qerror_per_sample=q, train_s=train_s,
         qerror_eval_s=eval_s,
         kernel_choice=fused_step_choice(256 * 256, 256, True, True, 4096, 64),
         launches=got, stream_bf16_qerror_per_sample=q16,
         stream_bf16_train_s=train16_s, stream_bf16_launches=got16,
         gate="qerror within 2% of the JAX anchor; stream_bf16 within 1% of it")

    # ---- find_qerror2 (fast): K1, K4 masked (phase 8a) ------------------
    qerror2_phase(smi, tally, k128["codes"], X100, km128["codes"], Xm128, mask128,
                  k256["codes"], X)

    # ---- e2e 64x64, 1M x 64: the grouped path, 62 K7 launches -----------
    (q, train_s, eval_s), (q_plain, train_plain_s, eval_plain_s), got = main_path(
        "e2e_64x64_1M", lambda: e2e(X, 64, 512, 16, 16384),
        ("dist_argmin", "dist_argmin_t", "som_vmem_train_steps"),
        lambda: e2e(X, 64, 512, 16, 16384))
    tally(got)
    (q_step, train_step_s, eval_step_s), _, got_step = main_path(
        "e2e_64x64_1M_stepwise", lambda: e2e(X, 64, 512, 16, 16384, vmem_steps=False),
        ("dist_argmin", "dist_argmin_t", "som_fused_factored_step"))
    tally(got_step)
    check_e2e("e2e 64 1M", q, q_plain)
    check_e2e("e2e 64 1M vs K13 per step", q, q_step)
    q_init = find_qerror(random_codes(X, 64), torch.from_numpy(X).to("cuda")) / X.shape[0]
    if not q < 0.8 * q_init:
        raise AssertionError(f"e2e 64 1M: qerror {q} not below 0.8 x the "
                             f"random-init {q_init}")
    emit("e2e_64x64_1M", card=smi, qerror_per_sample=q, train_s=train_s,
         qerror_eval_s=eval_s, plain_qerror_per_sample=q_plain,
         plain_train_s=train_plain_s, plain_qerror_eval_s=eval_plain_s,
         stepwise_qerror_per_sample=q_step, stepwise_train_s=train_step_s,
         stepwise_qerror_eval_s=eval_step_s, random_init_qerror_per_sample=q_init,
         launches=got, stepwise_launches=got_step)

    # ---- e2e 64x64, 1M x 64 at B 4096: the batch-chunked kernel ------------
    # the JAX trainer's choice there: chunk 1024, bf16 x-pattern and batches
    choice = fused_step_choice(64 * 64, 64, True, True, 4096, 64)
    if choice != (True, 512, 1024, True, True):
        raise AssertionError(f"e2e 64 B4096: kernel choice {choice}")
    (q, train_s, eval_s), (q_plain, train_plain_s, eval_plain_s), got = main_path(
        "e2e_64x64_1M_B4096", lambda: e2e(X, 64, 4096, 16, 16384),
        ("dist_argmin", "dist_argmin_t", "som_fused_factored_chunked_step"),
        lambda: e2e(X, 64, 4096, 16, 16384))
    tally(got)
    check_e2e("e2e 64 1M B4096", q, q_plain, 0.005)
    emit("e2e_64x64_1M_B4096", card=smi, qerror_per_sample=q, train_s=train_s,
         qerror_eval_s=eval_s, plain_qerror_per_sample=q_plain,
         plain_train_s=train_plain_s, plain_qerror_eval_s=eval_plain_s,
         kernel_choice=choice, launches=got,
         gate="qerror within 0.5% of the plain run")

    # ---- masked e2e 256x256, 1M x 64: every step masked ------------------
    Xm, mask, _ = masked_data(X, 8, 16384, every_other=False)
    del X
    (q, train_s, eval_s), (q_plain, train_plain_s, eval_plain_s), got = main_path(
        "e2e_masked_256x256_1M",
        lambda: e2e(Xm, 256, 4096, 64, 16384, mask=mask),
        ("dist_argmin_masked", "som_neighborhood_update_idx_masked"),
        lambda: e2e(Xm, 256, 4096, 64, 16384, mask=mask))
    tally(got)
    check_e2e("e2e masked 1M", q, q_plain)
    q_init = find_qerror(random_codes(Xm, 256, mask), torch.from_numpy(Xm).to("cuda"),
                         mask=torch.from_numpy(mask).to("cuda")) / Xm.shape[0]
    if not q < 0.8 * q_init:
        raise AssertionError(f"e2e masked 1M: qerror {q} not below 0.8 x the "
                             f"random-init {q_init}")
    emit("e2e_masked_256x256_1M", card=smi, qerror_per_sample=q,
         train_s=train_s, qerror_eval_s=eval_s, plain_qerror_per_sample=q_plain,
         plain_train_s=train_plain_s, plain_qerror_eval_s=eval_plain_s,
         random_init_qerror_per_sample=q_init, launches=got)

    # ---- LVQ: olvq1 over 1M labelled vectors, 65,536 codes --------------
    from som_lvq_pak_torch.models.eval import accuracy
    from som_lvq_pak_torch.models.som import Dataset

    del Xm, mask
    X, lab, table, codes, Xm, lab1, mask, small = lvq_setup()
    pct_init = accuracy(Dataset(points=X, labels=lab), codes, labels=table, device="cuda")[0]
    run = lambda: lvq_e2e(olvq1_trainer, {}, X, lab, codes, table, 16384)  # noqa: E731
    (pct, train_s, eval_s, trained), (pct_plain, train_plain_s, eval_plain_s, _), got = \
        main_path("e2e_olvq1_65536_1M", run, ("dist_argmin", "segment_sum"), run)
    tally(got)
    pct_olvq1 = pct
    # the same run again: every sum in a fixed order, so the codebook repeats
    # bit for bit; then an interrupted and resumed run against an
    # uninterrupted one
    pct_again, _, _, again = run()
    if not (np.array_equal(again.points.view(np.int32), trained.points.view(np.int32))
            and pct_again == pct):
        raise AssertionError("e2e olvq1: a rerun on the card is not bit-equal")
    resume = lvq_resume_check(X, lab, codes)
    check_accuracy("e2e olvq1", pct, pct_plain)
    if not pct > pct_init:
        raise AssertionError(f"e2e olvq1: accuracy {pct} not above the initial {pct_init}")
    emit("e2e_olvq1_65536_1M", card=smi, accuracy_pct=pct, train_s=train_s,
         accuracy_eval_s=eval_s, init_accuracy_pct=pct_init,
         plain_accuracy_pct=pct_plain, plain_train_s=train_plain_s,
         plain_accuracy_eval_s=eval_plain_s, launches=got, rerun_bit_equal=True,
         rerun_accuracy_pct=pct_again, resume=resume)

    # ---- LVQ: lvq3 from the olvq1 codebook, 256 K8 steps ----------------
    run = lambda: lvq_e2e(lvq_trainer("lvq3"), dict(alpha=0.01), X, lab, trained,  # noqa: E731
                          table, 16384, rlen=262_144)
    (pct, train_s, eval_s, lvq3_out), (pct_plain, train_plain_s, eval_plain_s, _), got = \
        main_path("e2e_lvq3_65536_1M", run, ("dist_top2", "dist_argmin", "segment_sum"),
                  run)
    tally(got)
    check_accuracy("e2e lvq3", pct, pct_plain)
    pct_again, _, _, again = run()
    if not (np.array_equal(again.points.view(np.int32), lvq3_out.points.view(np.int32))
            and pct_again == pct):
        raise AssertionError("e2e lvq3: a rerun on the card is not bit-equal")
    emit("e2e_lvq3_65536_1M", card=smi, accuracy_pct=pct, train_s=train_s,
         accuracy_eval_s=eval_s, start_accuracy_pct=pct_olvq1,
         plain_accuracy_pct=pct_plain, plain_train_s=train_plain_s,
         plain_accuracy_eval_s=eval_plain_s, launches=got, rerun_bit_equal=True)
    X262, lab262 = X[:262_144].copy(), lab[:262_144].copy()
    del X, lab, trained, lvq3_out, again

    # ---- LVQ: masked chunks, 4096 codes: olvq1 then lvq2 -----------------
    run = lambda: masked_lvq_e2e(Xm, lab1, mask, small, table)  # noqa: E731
    (pct_o, pct, train_s, eval_s), (pct_o_plain, pct_plain, train_plain_s,
                                    eval_plain_s), got = main_path(
        "e2e_masked_lvq_4096_100k", run,
        ("dist_argmin", "dist_argmin_masked", "dist_top2", "dist_top2_masked",
         "segment_sum"), run)
    tally(got)
    check_accuracy("e2e masked olvq1", pct_o, pct_o_plain)
    check_accuracy("e2e masked lvq2", pct, pct_plain)
    emit("e2e_masked_lvq_4096_100k", card=smi, olvq1_accuracy_pct=pct_o,
         accuracy_pct=pct, train_s=train_s, accuracy_eval_s=eval_s,
         plain_olvq1_accuracy_pct=pct_o_plain, plain_accuracy_pct=pct_plain,
         plain_train_s=train_plain_s, plain_accuracy_eval_s=eval_plain_s,
         launches=got)

    lvq_tool_phases(smi, tally, X262, lab262, Xm[:16384], lab1[:16384], mask[:16384], table)
    del Xm, lab1, mask, small

    # ---- the CLI's -fast tools (phase 13e) and sammon_fast -----------------
    cli_phase(smi, tally, X100, X262[:65_536], lab262[:65_536], table)
    del X262, lab262, X100

    # ---- the port's examples (phases 13f, 13g) -----------------------------
    example_large_som_phase(smi, tally)
    example_streaming_som_phase(smi, tally)
    release()

    # ---- the int8-winner training chain (tools/int8_step_ab) --------------
    # 256x256 B 4096, K14 with chunk 1024 and the bf16 x-pattern: step times
    # of the float32, int8_win and stagger chains with K17 beside them, then
    # 64 training steps each (K1 prologue) and their qerror (K2); the tool
    # raises unless int8_win's qerror is within 1% of float32's and the
    # stagger chain ends bit-equal to the float32 chain (K14's main form)
    ab, _, got = main_path(
        "e2e_int8_win_256x256_B4096", lambda: int8_step_ab.run(device="cuda"),
        ("dist_argmin", "som_fused_factored_chunked_step", "dist_argmin_t",
         "som_fused_factored_chunked_step[int8_win]",
         "som_fused_factored_chunked_step[stagger]", "fused_step_skeleton"))
    tally(got)
    emit("e2e_int8_win_256x256_B4096", card=smi, **ab, launches=got,
         gate="int8_win qerror within 1% of float32's; the stagger chain's codebook "
              "bit-equal to the f32 chain's (K14's main form)")
    # ---- the int8 winner probe (tools/int8_probe): library rates, K15, K16 --
    probe, _, got = main_path("int8_probe", lambda: int8_probe.run(device="cuda"),
                              ("int8_winner_probe", "f32_winner_probe"))
    tally(got)
    emit("int8_probe", card=smi, **probe, launches=got)

    # ---- the mesh phases: worlds of processes on this card ---------------
    release()  # the worlds' ranks share this card's memory
    mesh_phases(smi, tally, q_masked128)
    mesh_dryrun_phase(smi, tally)
    mesh_overlap_phase(smi, tally)
    four_card_phases(smi, tally)

    sources = {
        "dist_argmin": ("som_lvq_pak_torch/csrc/argmin_sm90.cu",
                        "som_lvq_pak_tpu/ops/pallas_distance.py:60"),
        "dist_argmin_t": ("som_lvq_pak_torch/csrc/argmin_sm90.cu",
                          "som_lvq_pak_tpu/ops/pallas_distance.py:426"),
        "split_codes": ("som_lvq_pak_torch/csrc/argmin_sm90.cu",
                        "||m||^2 of som_lvq_pak_tpu/ops/pallas_distance.py:165 (XLA, "
                        "K1's m2_ref) and :446 (in K2's kernel)"),
        "som_fused_train_step": ("som_lvq_pak_torch/csrc/fused_step_sm90.cu",
                                 "som_lvq_pak_tpu/ops/pallas_som.py:580"),
        "dist_argmin_masked": ("som_lvq_pak_torch/csrc/argmin_masked_sm90.cu",
                               "som_lvq_pak_tpu/ops/pallas_distance.py:74"),
        "som_neighborhood_update_idx": ("som_lvq_pak_torch/csrc/som_update_sm90.cu",
                                        "som_lvq_pak_tpu/ops/pallas_som.py:116"),
        "som_neighborhood_update_idx_masked": (
            "som_lvq_pak_torch/csrc/som_update_masked_sm90.cu",
                                               "som_lvq_pak_tpu/ops/pallas_som.py:152"),
        "som_vmem_train_steps": ("som_lvq_pak_torch/csrc/som_vmem_steps_sm90.cu",
                                 "som_lvq_pak_tpu/ops/pallas_som.py:1449"),
        "dist_top2": ("som_lvq_pak_torch/csrc/argmin_sm90.cu",
                      "som_lvq_pak_tpu/ops/pallas_distance.py:295"),
        "dist_top2_masked": ("som_lvq_pak_torch/csrc/argmin_masked_sm90.cu",
                             "som_lvq_pak_tpu/ops/pallas_distance.py:308"),
        "dist_topk": ("som_lvq_pak_torch/csrc/argmin_sm90.cu",
                      "som_lvq_pak_tpu/ops/pallas_distance.py:583"),
        "som_neighborhood_accumulate": ("som_lvq_pak_torch/csrc/som_accum_sm90.cu",
                                        "som_lvq_pak_tpu/ops/pallas_som.py:301"),
        "som_blend_winner": ("som_lvq_pak_torch/csrc/som_blend_winner_sm90.cu",
                             "som_lvq_pak_tpu/ops/pallas_som.py:401"),
        "som_fused_factored_step": ("som_lvq_pak_torch/csrc/separable_sm90.cuh",
                                    "som_lvq_pak_tpu/ops/pallas_som.py:743"),
        "som_fused_factored_chunked_step": ("som_lvq_pak_torch/csrc/separable_sm90.cuh",
                                            "som_lvq_pak_tpu/ops/pallas_som.py:904"),
        "som_fused_factored_chunked_step[int8_win]": (
            "som_lvq_pak_torch/csrc/som_fused_chunked_tc.cuh",
            "som_lvq_pak_tpu/ops/pallas_som.py:1056"),
        "som_fused_factored_chunked_step[stagger]": (
            "som_lvq_pak_torch/csrc/som_fused_chunked_tc.cuh",
            "som_lvq_pak_tpu/ops/pallas_som.py:1117"),
        "int8_winner_probe": ("som_lvq_pak_torch/csrc/winner_probe.cu",
                              "tools/int8_probe.py:95"),
        "f32_winner_probe": ("som_lvq_pak_torch/csrc/dist_argmin_t.cu",
                             "tools/int8_probe.py:154"),
        "fused_step_skeleton": ("som_lvq_pak_torch/csrc/fused_skeleton_sm90.cu",
                                "bench.py:505")}
    idle = [name for name in list(sources) + ["segment_sum"] if launches[name] == 0]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    sass_dump.check()
    emit("wall", card=smi, script_s=time.perf_counter() - t_script)
    # the LVQ steps' fixed-order segment sum: a kernel of the path that ports
    # no TPU kernel (the JAX package sums in XLA), so a line of its own
    print(json.dumps({"segment_sum": {
        "name": "segment_sum", "route": "cuda",
        "source": "som_lvq_pak_torch/csrc/segment_sum.cu",
        "replaces": "jax.ops.segment_sum in XLA, som_lvq_pak_tpu/models/fast.py:265",
        "launches": launches["segment_sum"],
        **{k: seg_rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "shape")}}}))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": recs[name]["max_abs_err"], "ms": recs[name]["ms"],
         "plain_ms": recs[name]["plain_ms"], "bound_ms": recs[name]["bound_ms"],
         "bound_by": recs[name]["bound_by"], "library_ms": recs[name]["library_ms"],
         "shape": recs[name]["shape"],
         **{k: recs[name][k] for k in ("route_bound_ms", "route_pct", "prologue_ms",
                                       "prologue_launch_ms") if k in recs[name]}}
        for name in sources]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
