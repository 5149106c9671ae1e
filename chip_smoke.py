#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card
    python3 chip_smoke.py --update-paths A B B A
                                   # the DANE update's cases, in turns,
                                   # on the checkouts at A and B

Phases, in order; any failure raises and the script exits non-zero:

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, all started together), printing ptxas's registers,
   stack frame and spills of every entry;
3. each kernel (K1-K10, K7-bwd, K8-bwd, K9-bwd, K10-bwd) at every shape
   phases 4-11d give it (K2 and K3 at
   both d=60 and d=784, K2 also on a rank's devices of the flat mesh
   and, with its steps cut short, of the tree, and on the 1- and 3-row
   cohorts a buffered refill solves, K3 too; K2 and K3 also at d=2,000
   and d=34,952 on numpy-seeded batches, K=10, nb=16, B=10: K2's global
   tier, up to the largest model the fused gate takes; K5 at the
   synthetic and FEMNIST-like flat packs
   and on an all-inactive cohort, K6 at a rank's slab of the flat and
   tree meshes, the FEMNIST-like pack and an all-inactive slab), on
   numpy-seeded inputs with a masked device and masked steps: held
   against its plain PyTorch version on the card, timed with CUDA events
   beside the plain version, its roofline bound (the bytes and flops the
   masks leave to do) and, for K5, K6 and K7, the one PyTorch call that
   computes the same function; for K1, K4, K5, K6 and K5/K6's call
   (``torch.einsum`` on weights made outside the timed call) also the
   device time of a launch, from one replay of a CUDA graph of 100
   launches (``device_ms``).  K1 on the synthetic, FEMNIST-like,
   Sent140 LSTM (4,800 rows) and Shakespeare LSTM (63,920 rows) packs;
   K4 as the per_leaf step launches it (every leaf of the stacked
   synthetic model, and the 9 leaves of the stacked Shakespeare LSTM,
   masked, each in one launch) and on each synthetic leaf's (rows,
   128) view; and one local step's whole update path in each generic
   solver mode -- ``ops.dane_update_masked`` (per_leaf) and
   ``ops.FlatUpdate.step`` (flat: pack g, K1, the views of w) -- with
   the kernels a step puts on the card (``torch.profiler``) and its
   launches: one a step in both, at most 3 kernels in flat.  K7 (flash
   attention) at (a) qwen1.5-0.5b's prefill, BH=16, S=T=4096, hd=64,
   causal, f32; (b) (a) in bf16; (c) yi-9b's GQA-folded prefill in the
   model's head order, B*Kv=4 slices of 8*2048 rows against T=2048 keys,
   hd=128, causal_period=2048, f32; (d) a ragged length, BH=16,
   S=T=1000, hd=64; (e) non-causal, BH=8, S=T=512, hd=64; (f) and (g)
   qwen's prefill at B=2, S=1024 and S=128
   (BH=32); (m) and (n) qwen3-moe-235b-a22b's GQA-folded prefills, 16
   query heads a KV head: B*Kv=4 slices of 16*4096 rows against 4096
   keys and 8 of 16*1024 against 1024, hd=64, causal_period=S; (o) and
   (p) jamba-v0.1-52b's, 4 query heads a KV head, hd=128: B*Kv=8
   slices of 4*4096 rows against 4096 keys and 16 of 4*1024 against
   1024; (q), (r) and (r') whisper-tiny's non-causal attentions (6
   heads of 64, B=8: BH=48): the encoder over 1,500 frames, 448
   training tokens against them and a prefill's one BOS token against
   them; and,
   writing the row log-sum-exp as training does, (a)'s
   shape and the trainer's local-step fold (K*B*H = 128 slices of S=64):
   f32 within atol 4e-5 / rtol 2e-5 (the reference's own sweep
   tolerance) and bf16 within 4e-3 / 1e-2 (one bf16 ulp and a margin:
   both sides round an f32 result once), beside SDPA's time.  K7's f32
   bound is its flops at the TF32 tensor-core rate (it multiplies there,
   in three passes), its bf16 bound at the bf16 rate.  K7's backward (a
   kernel of the port, no TPU counterpart), from the forward kernel's
   lse, against the explicit formula on the card (the worst of dq, dk,
   dv, K7's tolerances) at (h) the train step, BH=16, S=T=4096, hd=64,
   causal, f32; (i) the trainer's local-step fold, BH=128 (K*B*H =
   2*4*16), S=T=64; (i') its phase-A fold, BH=512 (K*nb*B*H); (j)
   yi-9b's GQA fold ((c)'s shape, period 2048, hd=128); (k) ragged,
   S=T=1000; (l) (h) in bf16; (q) and (r) whisper-tiny's encoder and
   cross-attention in training, non-causal: beside its bound (5
   products of 2*hd
   flops a visible pair, TF32 or bf16 rate), the plain version and
   ``torch.autograd.grad`` through SDPA (its backward).  K1 and K4 also
   at the trainer's qwen1.5-0.5b pack (K=2 devices of 463,987,712
   params: one flat launch; the tree's 14 leaves in one launch).  K8
   (the selective scan, a kernel of the port) at (s1) jamba's prefill
   B=1, S=4096, di=8,192, N=16, (s2) B=2, S=1024 and (s3) the reduced
   preset B=2, S=200, di=512, N=8, on numpy-seeded inputs (a random
   a_log), within K8_REL x max |y| of the plain step loop, beside its
   bound (the bytes, or the exponentials on the special-function
   units) and the plain loop's time over 3 calls; no PyTorch call
   computes it.  K8-bwd (the scan's backward, a kernel of the port) at
   (s1)-(s3) and (s3') the reduced trainer's fold of 2 clients (B=2x4,
   S=64, di=256, A one a client), from the states K8's training launch
   saved: each output within GRAD_REL x its max |g| of the plain reverse
   walk, two calls bitwise equal, and the training launch's y and H
   within K8_REL x their max of the plain forward's, beside its bound
   (the bytes, or the B*S*di*N exponentials the gradient needs) and the
   plain walk's time.  K9 and K10 (the mLSTM and sLSTM scans, kernels of
   the port) at xlstm-350m's (x1)/(y1) B=1 S=4096, (x2)/(y2) B=2 S=1024,
   (x3)/(y3) phase 10d's comparison prompt B=2 S=256 (H=4, dk=512,
   dh=256) and (x4)/(y4) the reduced preset B=2 S=100 (dk=128, dh=64),
   on numpy-seeded inputs, within XLSTM_REL x max |h| of the plain step
   loop, two calls bitwise equal, beside the bound (the bytes, or the
   flops of the state's update and read-out at the CUDA cores' f32 rate)
   and the plain loop's time; no PyTorch call computes either.  K9-bwd
   and K10-bwd (their backward, kernels of the port) at (x1)/(y1),
   (x2)/(y2), (x4)/(y4) and (x5)/(y5) the reduced trainer's fold of 2
   clients (B=2x4, S=64, dk=64, dh=32, the sLSTM's r in 2 groups), K9-bwd
   also at (x6) B=2 S=201 at full width (a partial chunk and sub-chunk),
   K10-bwd also at (y6) the fold of 2 clients at full width (B=2x1,
   S=1024, dh=256, r in 2 groups), from
   the states the training launches saved: each output within GRAD_REL
   x its own max |g| of the plain backward, two calls bitwise equal, and
   the training launches' h and states within XLSTM_REL x their max of
   the plain forward's, beside the bound (the bytes, or the walk's flops
   at the f32 rate); each K9-K10-bwd case prints its time a step and its
   plan, and the cluster ones how many of their clusters fit the card at
   once.  Every
   plain step loop of the scans (K8-K10 and their backward) runs once,
   its comparison call timed with CUDA events;
4. the paper's experiment on the card -- synthetic(1,1), N=30, K=10,
   E=20, B=10, lr=0.01 -- for feddane, fedprox (mu=0.001) and fedavg,
   5 rounds each with the default ``local_solver="auto"``, held round by
   round against the same config on the port's CPU path (plain
   versions; phases 4, 6 and 7 run it on ``CPU_SOLVER``, K2's plain
   version, the mode ``auto`` takes on the card): the same selections,
   params within tolerance;
5. feddane for 2 rounds in each explicit solver mode: flat and per_leaf
   bitwise equal on the card, each mode's kernel launched, and one
   update launch a step in both generic modes (as many K4 launches in
   per_leaf as K1 launches in flat);
6. FEMNIST-like logistic regression at full width (d=784, C=10, N=200,
   K=10, E=20), feddane, 3 rounds on "auto" plus one round on
   "fused_step", held against the CPU path to a multiple of the spread
   that float32 rounding causes there (measured on the CPU path);
7. scenarios and lossy codecs on the paper config: feddane and fedavg
   under ``scenario="hostile"`` (availability, partial-credit
   stragglers, dropout and partial work at once: masks, truncated
   solves and a thinned gather) with each lossy codec (int8, topk,
   dp_gauss), plus feddane with the dense codec, 3 rounds each against
   the CPU path: the same selections and masks every round, params
   within tolerance (int8 within 4x its own measured sensitivity), and
   one K5 launch per lossy round on the card;
8. the paper's non-convex tasks (Fig. 1) through the LSTMs at full
   width with Fig. 1's settings, on the python driver with vmap's
   per-sample fallback switched off: Sent140-like (N=772, K=10, B=10,
   ``sentlstm_specs(400, 25, 100)``, lr=0.1, E cut from 2 to 1) for
   feddane (mu=0.001), fedprox (mu=1) and fedavg, 2 rounds each on
   ``auto`` (which is ``flat``: K1 once a local step), held round by
   round against the CPU path as phase 6 holds FEMNIST-like (the spread
   a 1e-7 nudge of w0 on every leaf causes there), the feddane cell's
   loss over a seeded sample of 50 devices too; Shakespeare-like (N=143,
   ``charlstm_specs(80, 8, 256)``, lr=0.3, E=1, sample_cap cut to 32)
   feddane 2 rounds on ``flat`` (its first round held to the CPU path)
   and on ``per_leaf``: bitwise equal, K4 launched as often as K1 (once
   a step over all 9 leaves); then one card-only round at sample_cap
   512, timed on the host clock.  Each task's local step in parts: the
   host's ``vmap(grad)`` (its idle share under the profiler) against
   K1's time.  The CPU path's runs of phases 8 and 8c (each cell's run
   from w0 and its two nudged runs) are submitted before phase 4 to a
   pool of CPU_WORKERS spawned processes, each on a third of the host's
   cores at a lower priority (CPU_WORKER_NICE) and making its data anew
   from the seeds; phases 4-8c run beside them and each check waits for
   its runs;
8b. the scanned driver (``round_driver="scan"``), each round one replay
   of a captured CUDA graph: the paper config for feddane, fedprox and
   fedavg, 5 rounds in one chunk on injected selections (drawn by the
   port's sampler from a CPU generator), held to the CPU scanned driver
   (on ``fused_epoch``, the mode ``auto`` takes on the card, in its
   plain version) within TRAJECTORY_TOL (params; the loss relative to
   max(1, |loss|); the rest of the history exactly), K2 launched once a
   replay; feddane sampled on the card, 20
   rounds in chunks of 10, run twice: bitwise equal, the selections
   (recorded inside the graph) not all alike, ms/round of the second
   run beside the python driver's on the same config, the card's idle
   share over one chunk of each; feddane under ``hostile`` with int8, 3
   rounds on injected selections and numpy-seeded environment uniforms
   (through ``engine.scan_env_uniforms``): masks, work fractions and
   phase-A availability bitwise equal to the CPU scanned driver, the
   same effective K, params within phase 7's int8 limit, K5 once a
   replay; Sent140-like feddane (phase 8's settings) on phase 8's
   CPU-path selections, held to phase 8's limits, then timed in a
   second run beside phase 8's python-driver rounds;
8c. the buffered driver (``round_driver="buffered"``, an event queue of
   stale clients; ``num_rounds`` counts commits), every cell at full
   width: the paper config's feddane, fedprox and fedavg with M=K,
   ``ideal`` and constant weights, 3 commits, held to the card's python
   driver and to the CPU buffered driver (on ``fused_epoch``'s plain
   version) within TRAJECTORY_TOL, staleness 0, K2 once a commit;
   feddane and fedavg under ``hostile`` with M=5, polynomial weights
   and max staleness 3, 5 commits: the event stream (every history
   list but the loss) equal to the CPU path's, params within 4x the
   spread a 1e-7 nudge of w0 causes there, a second card run bitwise
   equal, ms/commit and commits per unit of simulated time beside phase
   7's python-driver ms/round, the idle share over 3 commits; feddane
   ``hostile`` int8 M=5, 3 commits, held the same way, K5 never
   launched (the commit reduces the decoded deltas itself); scaffold
   with replacement, 1 commit, its duplicate clients solved in
   occurrence layers, held to the card's python driver; Sent140-like
   feddane (phase 8's settings), M=K, 2 commits, phase 8's selections,
   within phase 8's limit of its card params, K1 once a local step.
   Everywhere K2 launches once a cohort solve (refills of 1 to K rows);
8d. the population layer (``data/shard_source.py``) at the reference's
   acceptance settings: a streaming synthetic(1,1) source of N=10^6
   clients on the card (seed 7, eval over 32 clients), K=10, E=1, B=10,
   lr=0.05, mu=0.01, seed 5.  feddane 3 rounds on the python driver
   against the CPU path (the same numpy selections, params and loss
   within TRAJECTORY_TOL), then on the scanned driver's streaming plan
   on those selections (run twice, bitwise; its captures, one per padded
   batch count), a 3-commit buffered feddane against the CPU buffered
   driver (the same event stream), and SCAFFOLD 2 rounds (at most 20
   controls in the sparse store); K2 once a round, replay or commit;
   each with ms/round (CUDA events), clients generated (at most
   32 + 2 x 10 x 3), the card's peak allocated bytes above the run's
   start (under 256 MiB) and the host's peak RSS growth.  At N=30,
   streaming against the stacked plan with sampled selections: the
   schedule's eager draws equal the captured round's draws bit for bit,
   params within 1e-5.  The reference's directional cell: ``bernoulli``,
   4 scanned rounds of fedavg, fedprox and feddane at K/N = 1e-5, the
   final losses and whether feddane's is over 1.5x both (printed);
9. the client mesh (``core/sharding.py``) on the paper config, its
   ranks started by ``run_on_mesh`` on cuda:0 over gloo (NCCL refuses
   two ranks on one device), on all three drivers: a flat mesh of 2
   ranks for the python driver (feddane and scaffold, ideal and dense,
   and fedavg with topk, its error feedback carried across the ranks; 3
   rounds), the scanned driver (feddane sampled on the card, 5 rounds;
   scaffold on numpy-seeded selections, 3 rounds, ``sharded`` 1.0),
   the buffered driver (feddane under ``hostile``, M=5, 5 commits: its
   refills of one client pad to two rows) and the N=10^6 streaming
   source of phase 8d (feddane on the python and scanned drivers, 2
   rounds: each rank generates at most the 32 eval clients and its 5
   of each phase and round); and a tree of 10 ranks under 2 edges (one
   client a rank) for feddane under ``hostile`` with int8 on the python
   and scanned drivers (3 rounds) and degenerate on the buffered driver
   (3 commits).  The scanned cells run twice, bitwise equal: the
   captures (each round program CUDA-graph segments split at its
   all-reduces, at least two), then the timed replays.  Every rank must
   end with bitwise-equal params, loss history, selections, masks and
   per-client state; each cell is held against the single-process card
   run of the same driver and seed (the same selections, masks and
   effective K every round, the buffered event stream; params within
   phase 4's bound, or phase 7's spread-based bound for int8); K2 must
   launch, K6 once per rank and lossy round (a replay, or a capture's
   warm-up) and K5 never in the ranks (each rank sets its counters to 0
   just before each cell and reads them just after).  Each cell prints
   ms/round (ms/commit) on rank 0 beside the single process, the
   segments and all-reduces of each captured program, and K2 and K6
   launches summed over the ranks;
10. the LM stack's inference path at full width, random weights from
   seed 0, f32: qwen1.5-0.5b (24 layers, d=1024, 16 heads) through
   ``make_prefill_step`` at B=2, S=128 held against the port's CPU path,
   and at B=1, S=4096 and B=2, S=1024 against the same model on the card
   with the plain attention (logits within 1e-4 x max |logit|, the same
   argmax; K7 launched exactly 24 times a prefill; ms per prefill from
   CUDA events); the card's idle share over one profiled B=1, S=4096
   prefill; ``serve.generate`` at serve's defaults (B=2, a 16-token
   prompt, 16 new tokens, cache 128), whose greedy tokens must equal the
   CPU path's; yi-9b at full width cut to 4 of its 48 layers (32 heads
   on 4 KV heads), B=1, S=2048, against the card's plain attention, K7
   launched 4 times; then qwen3-moe-235b-a22b at full width (d=4096, 64
   heads on 4 KV heads, hd=64, E=128 experts top-8, expert d_ff 1536,
   V=151,936) cut to MOE_LAYERS=2 of its 94 layers, its weights drawn
   on the card from a seeded CUDA generator: (a) one layer's
   ``moe_ffn`` at B=1, S=4096 on seeded hidden states against the
   per-expert plain version ``moe_ffn_plain`` on the card (within
   MOE_REL x max |out|, the aux within MOE_AUX_TOL), with the dropped
   pairs and the busiest expert's load against Cb=320; (b) ties, a zero
   router and one with duplicated columns on inputs whose router logits
   are exact in f32: the experts, their order and the slots equal the
   CPU path's; (c) prefill at B=1, S=4096 and B=2, S=1024 against the
   plain attention on the card (logits within LOGIT_REL, argmax equal;
   K7 launched once a layer), with the routing choices that differ
   between the two runs; where they differ and the logits do not agree,
   the case is held with the K7 run's expert choices injected into the
   plain run (``moe.route`` swapped: the plain run's own router softmax,
   gates and aux on those experts), and says so; the idle share of one
   profiled B=1, S=4096 prefill; (d) ``serve.generate`` at B=2 (16-token
   prompt, 16 new tokens, cache 128): no kernel launched, greedy tokens
   equal to the same generation with ``moe.moe_ffn`` swapped for the
   plain version; the 24.6 GB are freed before phase 11;
10c. the hybrid arch: jamba-v0.1-52b at full width (d=4096, 32 heads on
   8 KV heads, hd=128, di=8,192, N=16, 16 experts top-2, d_ff 14,336,
   V=65,536) cut to JAMBA_LAYERS=8 of its 32 layers, one repeat of its
   pattern (7 mamba blocks, 4 of them with the MoE FFN, and 1
   attention block; 13.30 B params), weights drawn on the card from
   seed 0, f32, TF32 off: (a) one mamba layer's ``mamba_mixer`` at B=1,
   S=4096 on seeded hidden states through K8 against the plain scan on
   the card (``ssm.selective_scan`` swapped for ``ssm.plain_scan``;
   within K8_REL x max |out|); (b) prefill at B=1, S=4096 and B=2,
   S=1024 against the plain attention and the plain scan on the card
   (logits within LOGIT_REL, argmax equal; K7 exactly once and K8
   exactly 7 times a prefill), with the routing choices that differ and,
   where they differ and the logits do not agree, the kernels' run's
   choices injected; ms a prefill and the idle share of one profiled
   B=1, S=4096 prefill; (c) ``serve.generate`` at B=2 (16-token
   prompt, 16 new tokens, cache 128): no kernel launched, the logits
   after the prompt (the decode path's SSM state and conv window)
   within LOGIT_REL of the prefill's last position (K8's scan), argmax
   equal (the prefill's expert choices injected where a flip makes them
   disagree); ms a decode step; the 49.5 GiB freed before phase 11;
10d. xLSTM: xlstm-350m at full width and full depth (24 layers, 12 sLSTM
   and 12 mLSTM blocks, d=1,024, H=4, dk=512, dh=256, V=50,304;
   405,185,632 params, 1.62 GB), weights drawn on the card from seed 0,
   f32: (a) one mLSTM and one sLSTM layer's mixer through K9 and K10
   (once each) against the plain scans on the card at B=1,
   S=XLSTM_MIXER_CMP_S=1024 (``xlstm.mlstm_scan`` / ``slstm_scan``
   swapped for ``ref.mlstm_scan_ref`` / ``slstm_scan_ref``; within
   XLSTM_REL x max |out|; phase 3 holds both at S=4096), then timed at
   S=4096; (b) the prefill at XLSTM_CMP = B=2,
   S=256 against the plain scans on the card (logits within LOGIT_REL,
   argmax equal; K9 and K10 exactly 12 times each a prefill); (c) ms a
   prefill at B=1 S=4096 and B=2 S=1024, and the idle share of one
   profiled B=1 S=4096 prefill; (d) ``serve.generate`` at B=2 (16-token
   prompt, 8 new tokens, cache 128): no kernel launched, the logits after
   the prompt within LOGIT_REL of the CPU path's on the same weights and
   greedy tokens equal (decode starts the stabiliser m at 0, the prefill
   at -1e30, so decode is not held to the prefill); ms a decode step;
10e. the encoder-decoder: whisper-tiny at full width and full depth (4
   encoder + 4 decoder layers, d=384, 6 heads of 64, d_ff 1,536,
   V=51,865; 56,371,200 params), weights drawn on the card from seed 0,
   f32: (a) ``make_prefill_step`` on the reference's serving batch
   (frame embeddings for the encoder, one BOS token for the decoder) at
   B=8 x 1,500 frames (Whisper's 30-s window) and B=1 x 4,096, against
   the plain attention on the card (logits within LOGIT_REL, argmax
   equal; K7 exactly 12 times a prefill: the encoder's self-attention,
   the decoder's and its cross-attention over the frames, 4 layers
   each), ms a prefill and the idle share of one; (b) 3 ``decode_step``
   calls on random ``ck`` / ``cv`` of 1,500 rows against the CPU path's
   (no kernel launched), ms a step; (c) ``serve.generate`` at B=2
   (4-token prompt, 8 new tokens, cache 64) with 1,500 frames, the
   cross caches filled from the encoder (K7 once an encoder layer): the
   decode path's logits at every prompt position within LOGIT_REL of
   the teacher-forced forward's (K7) and each greedy token that
   forward's argmax; without frames (the reference's loop: zero cross
   caches, which no reference code writes) greedy tokens equal to the
   CPU path's;
11. LM training at full width, qwen1.5-0.5b, random weights from seed
   0, f32: (a) ``loss_fn`` and its gradient at B=1, S=64 against the
   CPU path (the loss within LOGIT_REL relative, each leaf within
   GRAD_REL of its max |g|), K7 once forward and once backward a layer;
   (b) ``make_feddane_round_step`` at train_4k's S=4096, B=1,
   remat="full", 3 steps on one batch: the loss falls, params within
   TRAIN_STEP_TOL of the same steps with the plain attention on the
   card, ms a step (CUDA events), the card's peak bytes, K7 4x24
   forward and 2x24 backward launches a step; one step each of
   ``make_fedavg_step`` and the pipelined step; (c) ``launch/train.py``'s
   ``main`` with ``--full-size``: feddane N=8, K=LM_TRAIN_K (2: K=4
   does not fit the card), E=1, B=4, S=64, 16 samples a device, 2
   rounds on ``auto`` (= flat, K1 once a local step; K7 exactly 24
   forward and 24 backward launches a local step, all K clients folded),
   held to the same run with the plain attention on the card (the same
   selections, params within TRAJECTORY_TOL), then 1 round on
   ``per_leaf``, bitwise equal to flat's first (K4 once a local step);
   ms/round (CUDA events), the card's peak bytes, the idle share of one
   local step; (d) pods as clients: one pod, E=1 against
   ``make_feddane_round_step`` within POD_TOL; 2 pods x 2 local steps, 1
   round, finite;
11b. training the MoE archs: qwen3-moe-235b-a22b at full width cut to
   MOE_TRAIN_LAYERS=1 of its 94 layers (3.70 B params, 14.79 GB f32:
   a fedavg step's 4 model-sized buffers fit the card, a feddane
   step's 6 do not), weights drawn on the card from seed 0, f32, TF32
   off: (a) one layer's ``moe_ffn`` gradient (x and every weight) at
   B=1, S=MOE_TRAIN_S=4096 against ``moe_ffn_plain``'s on the card
   (each leaf within GRAD_REL of its max |g|), two runs bitwise equal,
   the dropped pairs, ms of each; (b) its ``vmap(grad)`` over the data
   of MOE_VMAP = 2 clients x B=4 x S=64 (the trainer's local step,
   vmap's fallback off) against each client's own gradient: bitwise,
   or within VMAP_REL, saying which; (c) ``loss_fn``'s gradient at B=1,
   S=4096, ``remat="full"``, through K7 and K7-bwd (K7 twice and K7-bwd
   once a layer), two runs bitwise equal, against the plain attention
   on the card (the loss within LOGIT_REL, each leaf within GRAD_REL),
   with the routing choices that differ between the two runs; where
   they differ and the gradients do not agree, the plain run is held on
   the K7 run's expert choices (``moe.choose``); (d) one
   ``make_fedavg_step`` on that batch: its loss bitwise (c)'s, its
   params bitwise params - eta g of (c)'s gradient, ms and the card's
   peak; (e) qwen3-moe and arctic-480b at ``launch/train.py``'s reduced
   preset (d=128, 2 layers, V=256, 4 experts top-2): one step of each
   train step builder at B=4 S=64 (K7's launches counted),
   ``train.main`` feddane N=8 K=2 E=1 B=4 S=64, 2 rounds on ``auto``
   (= flat, K1 once a local step) against the same run on the CPU path
   (in the pool: the same selections, params within TRAJECTORY_TOL),
   then 1 round on ``per_leaf`` bitwise equal to flat's first (K4 once
   a local step); pods as clients, 2 pods x 2 local steps, finite;
11c. training the hybrid arch: jamba-v0.1-52b at full width, weights
   drawn on the card from seed 0, f32: (b) one ``mamba_mixer``'s
   gradient (x and every weight) through K8 and K8-bwd (once each)
   against the plain scan's autograd on the card at B=1,
   S=JAMBA_MIXER_CMP_S=1024 (each leaf within GRAD_REL of its max |g|;
   phase 3 holds K8-bwd at S=4096), then timed at S=4096; (c) ``loss_fn``'s gradient at its
   first JAMBA_TRAIN_LAYERS=2 layers (mamba, mamba_moe: 3.74 B params)
   at B=1, S=4096, ``remat="full"`` (K8 twice and K8-bwd once a layer),
   two runs bitwise equal, against the plain scan route on the card
   (the loss within LOGIT_REL, each leaf within GRAD_REL; the routing
   choices that differ, and the plain run held on the K8 run's where
   they differ and the gradients do not agree); (d) ``make_fedavg_step``
   on that batch, twice: its loss bitwise (c)'s, its params bitwise
   params - eta g, ms and the card's peak; (e) at the first layer
   alone, 3 ``make_feddane_round_step`` steps at S=4096 (the loss
   falls; ms a step, peak) and 3 at S=JAMBA_STEP_CMP_S against the
   plain scan's (params within TRAIN_STEP_TOL), one pipelined step;
   (f) ``train.main --arch jamba-v0.1-52b --layers 1 --lr
   JAMBA_TRAIN_LR``: feddane N=8 K=2 E=1 B=4 S=64, 2 rounds on ``auto``
   (= flat; K8 and K8-bwd once a mamba layer, K7 and K7-bwd once for
   the attention layer, in each local step for both clients) against
   the CPU path (in the pool: the same selections, params within
   TRAJECTORY_TOL), 1 round on ``per_leaf`` bitwise equal to flat's
   first, pods as clients, 2 pods x 2 local steps, finite;
11d. training xLSTM: xlstm-350m at full width and depth (24 layers),
   weights drawn on the card from seed 0, f32: (a) one mLSTM and one
   sLSTM mixer's gradient (x and every weight) through K9/K10 and
   K9-bwd/K10-bwd (once each) against autograd of the plain scans on the
   card at B=1, S=XLSTM_MIXER_CMP_S=1024 (each leaf within GRAD_REL of
   its max |g|; phase 3 holds both backward kernels at S=4096), then
   timed at S=4096; (b)
   ``loss_fn``'s gradient, ``remat="full"`` (K9/K10 twice and
   K9-bwd/K10-bwd once a layer), at XLSTM_GRAD_CMP (B=1, S=256, four
   chunks) against the plain scans' route (remat none; loss within
   LOGIT_REL, each leaf within GRAD_REL; the worst leaf named, with the
   move of its gradient through the kernels under an XLSTM_NUDGE x |p|
   nudge of the params), then at B=1 S=4096 twice,
   bitwise equal, ms and the card's peak; (c) ``make_fedavg_step`` at
   B=1 S=4096 (its loss and params bitwise (b)'s loss and params - eta
   g), 3 ``make_feddane_round_step`` steps (the loss falls) and a
   pipelined step, ms and peaks; (d) ``train.main --arch xlstm-350m
   --lr XLSTM_TRAIN_LR`` (4 layers, d=128): feddane N=8 K=2 E=1 B=4
   S=64, 2 rounds on ``auto`` (= flat; K9, K10, K9-bwd and K10-bwd once
   a layer of their kind in each local step for both clients) against
   the CPU path (in the pool: the same selections, params within
   TRAJECTORY_TOL; the CPU path's own spread from weights nudged by
   1e-7 printed at that lr and at 0.05), 1 round on ``per_leaf``
   bitwise equal to flat's first, pods as clients, 2 pods x 2 local
   steps, finite;
11e. training the encoder-decoder: whisper-tiny at full width and
   depth, weights drawn on the card from seed 0, f32: (a) ``loss_fn``'s
   gradient, ``remat="full"``, at B=8, 1,500 frames, 448 tokens, with
   random frames and with the trainer's zero frames, against the plain
   attention's route (remat none) on the card (the loss within
   LOGIT_REL, each leaf within GRAD_REL of its own max |g|; K7 24 and
   K7-bwd 12 times: 12 attentions, each forward twice and backward
   once), two timed runs and the card's peak; (b) ``make_fedavg_step``
   (its loss and params bitwise (a)'s loss and params - eta g), 3
   ``make_feddane_round_step`` steps (the loss falls) and a pipelined
   step at that shape, with exact K7 and K7-bwd counts; one gradient at
   B=1, frames = tokens = 4,096; (c) ``train.main --arch whisper-tiny``
   (2 + 2 layers, d=128, zero frames, lr 0.05): feddane N=8 K=2 E=1 B=4
   S=64, 2 rounds on ``auto`` (= flat; K7 and K7-bwd 6 times a local
   step for both clients) against the CPU path (in the pool: the same
   selections, params within TRAJECTORY_TOL x max(1, each leaf's max
   |p|); the CPU path's own spreads from weights nudged by 1e-7 x w and
   by 1e-7 added, printed), 1 round on ``per_leaf`` bitwise equal to
   flat's first, pods as clients, 2 pods x 2 local steps, finite; (d)
   one round of ``train.main --full-size`` (K=2, N=8, E=1, B=4, S=64):
   K1 once and K7, K7-bwd 12 times a local step, ms and the card's
   peak;
12. the ``kernels`` JSON line: every kernel with its launches on the
   main path -- phases 4-8d in this process (the counters are set to 0
   just before phase 4 and read just after phase 8d; a captured kernel
   counts once a replay, and once for the warm-up run before its
   capture), phase 9's ranks, phase 10, phases 10c, 10d and 10e,
   phases 11-11c, phase 11d and phase 11e (each set to 0 just before it
   and read just after) -- error,
   times and bound, and each checked shape under ``cases`` (with its
   ``device_ms`` where phase 3 took one, and the update paths' kernels
   and launches a step).

Phases 4-7 also run one more round of the auto, fused_step and
phase-7 cells under ``torch.profiler`` and print the card's idle share
in it (phase 8: one local step of each LSTM task).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src/repro_torch`` beside this
script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth; float32 FMA
#: throughput outside the tensor cores (K1-K6 use no tensor core); the
#: dense TF32 tensor-core rate (K7's float32 bound: it multiplies on the
#: tensor cores in three TF32 passes, so the 67 TFLOP/s of the CUDA cores
#: would put it over its own bound); the dense bf16 tensor-core rate (K7's
#: bf16 bound).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
#: exponentials a second on the special-function units: 16 a clock an SM
#: (NVIDIA's CUDA C++ Programming Guide, arithmetic instruction
#: throughput, compute capability 9.0) x 132 SMs x the 1,980 MHz boost clock; K8's bound by operations.
PEAK_SFU_OPS = 16 * 132 * 1.98e9

#: Flat and per-leaf updates round op by op like the plain version.
UPDATE_TOL = 0.0
#: The whole-epoch solve chains up to E*nb = 2560 dependent f32 steps whose
#: dot products sum in another order than the plain version's cuBLAS calls.
EPOCH_TOL = 1e-4
#: One step: a dot product of length d (60 to 34,952) summed in another
#: order.
STEP_TOL = 1e-5
#: The card's fused solve (analytic gradient) against the CPU path's
#: autodiff + flat update, over 5 rounds of 2560 steps.
TRAJECTORY_TOL = 1e-4
#: K5 and K6 add the cohort in client order with every product and sum
#: rounded on its own (built with -fmad=false), like their plain versions.
CODEC_TOL = 0.0
#: The FEMNIST-like feddane round amplifies float32 rounding about 1e4-fold:
#: its correction g - g_k moves with the Hessian (~1e3 at d=784) times any
#: change of w, and enters every one of the E*nb local steps.  Phase 6
#: measures that spread on the CPU path itself (a 1e-7 nudge of the
#: starting weights, two directions) and holds the card to SPREAD_FACTOR
#: times it.  The limit must stay under MAX_REL_LIMIT of the params' scale,
#: so that a wrong d=784 solve still fails; the kernels themselves are held
#: to EPOCH_TOL and STEP_TOL at d=784 in phase 3.
SPREAD_FACTOR = 4.0
MAX_REL_LIMIT = 0.01
#: K7 against its plain version, (atol, rtol) by input dtype.  f32: the
#: reference's flash-attention sweep tolerance (tests/test_kernels.py).
#: bf16: both sides compute in f32 and round once to bf16, so they differ
#: by at most one bf16 ulp (<= 2^-7 |x|); the sweep's 4e-2 would exceed a
#: typical output at S=4096 (~0.03 for late rows).
FLASH_TOL = {"f32": (4e-5, 2e-5), "bf16": (4e-3, 1e-2)}
#: Phase 10: full-width logits on the card against the CPU path or the
#: card's plain attention, relative to max |logit|: 24 layers of f32
#: products summed in another order.
LOGIT_REL = 1e-4
#: K8 and the mixer against the plain step loop: within this x max |y|
#: (f32 exp and sums in another order, over a decaying recurrence).
K8_REL = 1e-5
#: K9, K10 and the xLSTM mixers against the plain step loops: within
#: this x max |h| (f32 exp and sums in another order over a stabilised
#: recurrence).
XLSTM_REL = 1e-5

#: Phase 10's MoE cells: qwen3-moe-235b-a22b at full width, cut to
#: MOE_LAYERS of its 94 layers (6.1 B params, 24.6 GB in f32).
MOE_LAYERS = 2
#: Phase 10c: jamba-v0.1-52b at full width, cut to one repeat of its
#: 8-block pattern (8 of 32 layers: 13.30 B params, 49.53 GiB in f32).
JAMBA_LAYERS = 8
#: Phase 10: one full-width ``moe_ffn`` against the per-expert plain
#: version on the card, relative to max |out| (4,096-long f32 dot
#: products in another order, 8 gated terms a token); the aux absolute.
MOE_REL = 1e-4
MOE_AUX_TOL = 1e-6

#: Phase 11: the LM trainer's devices a round.  K=4 does not fit the
#: 80 GB card: phase A's (K, nb) per-batch gradients of the 464 M-param
#: model alone take K*nb*1.73 GiB, and a K=4 round on an H100 80GB ran
#: out of memory with 62.7 GiB allocated; K=2 peaks at 43.6-46.7 GiB.
LM_TRAIN_K = 2
#: Phase 11: a full-width gradient leaf on the card against the CPU path
#: (or the card's plain attention), relative to the leaf's max |g|: 24
#: layers of f32 products and K7's 3xTF32 sums in another order.
GRAD_REL = 1e-4
#: Phase 11: params after the train_4k steps, K7 against the plain
#: attention on the card (absolute; the steps move params by ~eta |g|,
#: which the check requires to be 10 times larger).
TRAIN_STEP_TOL = 1e-6
#: Phase 11: the pod round with one pod and E=1 against the FedDANE
#: step, the reference's own bar (tests/test_podfed.py).
POD_TOL = 2e-5

#: Phase 11b: qwen3-moe-235b-a22b trained at full width, cut to this many
#: of its 94 layers: 3.70 B params, P = 14.79 GB in f32.  A fedavg step
#: holds 4P (params, g, eta g, the new params); a feddane step's 6P and
#: the pipelined step's do not fit the 80 GB card, nor does arctic's
#: gradient (14.07 B params at one layer).
MOE_TRAIN_LAYERS = 1
#: Phase 11b (a), (c), (d): train_4k's sequence, its batch cut to 1.
MOE_TRAIN_S = 4096
#: Phase 11b (b): the trainer's local step, clients x B x S.
MOE_VMAP = (2, 4, 64)
#: Phase 11b (b): ``vmap(grad)`` against separate gradients where they
#: are not bit for bit equal, relative to the gradient's max |g| (over
#: all its leaves).
VMAP_REL = 1e-6

#: Phase 11c: jamba-v0.1-52b trained at full width, cut to its first
#: JAMBA_TRAIN_LAYERS layers (a mamba block with the dense FFN, then one
#: with the 16-expert MoE: 3.74 B params, P = 13.94 GiB in f32): a
#: fedavg step's 4P fits the card, a feddane step's 6P does not; the
#: feddane steps (e) run on the first layer alone (0.818 B params).
JAMBA_TRAIN_LAYERS = 2
JAMBA_STEP_LAYERS = 1
#: Phase 11c (e): the steps' eta (at 1e-3 three steps move the
#: one-layer cut's params by only 1e-5, 10 x TRAIN_STEP_TOL) and the
#: sequence of the 3 steps held against the plain scan's (whose Python
#: loop of the step takes ~16 s a gradient a layer at S=4096).
JAMBA_STEP_ETA = 1e-2
JAMBA_STEP_CMP_S = 1024
#: Phase 11c (f): the reduced trainer's lr.  At train.py's default 0.05
#: jamba's trajectory amplifies rounding, in the reference as in the
#: port (tests/test_torch_moe_train.py: a 1e-7 nudge of the weights
#: moves the reference's g_t by > 1e-4 in one feddane step, with no
#: expert choice flipped), so no two f32 runs could agree within
#: TRAJECTORY_TOL over 2 rounds there; 0.005 takes smaller steps.
JAMBA_TRAIN_LR = "0.005"
#: Phase 11c (b): the mixer's gradient is held to the plain scan's
#: autograd at B=1 and this S (phase 3's K8-bwd row holds the kernel at
#: S=4096), and timed at S=4096.
JAMBA_MIXER_CMP_S = 1024

PAPER = dict(num_devices=30, devices_per_round=10, local_epochs=20,
             local_batch_size=10, learning_rate=0.01, seed=0)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, launches: int, repeats: int = 5,
            warm: bool = True) -> float:
    """Median over ``repeats`` of CUDA-event time per call, each repeat
    ``launches`` back-to-back calls after a warm-up call (none where
    ``warm`` is False: the caller has just run ``fn``)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def graph_ms(torch, fn, launches: int = 100, repeats: int = 5) -> float:
    """Device time per call: the median over ``repeats`` of CUDA-event
    time around one replay of a CUDA graph that captured ``launches``
    calls of ``fn`` (a ctypes launch goes to the current stream, which is
    the capturing one), so that no host work lies between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # warm-up: the library, the allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return statistics.median(times)


def kernels_per_call(torch, fn, attempts: int = 3):
    """Device activities (kernels, copies, sets) ``torch.profiler``
    records for one call of ``fn`` after a warm-up call; None if it
    records none at all in ``attempts`` profiled calls (the profiler
    now and then records nothing for a call that launched kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            return n
    return None


def max_err(torch, a, b) -> float:
    from repro_torch.core import pytree as pt
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(pt.leaves(a), pt.leaves(b)))


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks(torch, syn, fem):
    """Phase 3: K1-K8 and the backwards against their plain versions at every shape that
    phases 4-10 give them; returns the rows of the kernels line (launches
    filled in later).  A row's ``max_abs_err`` is the worst of its
    cases; its times and bound are those of its first case."""
    from repro_torch.core import pytree as pt
    from repro_torch.core.client import _epoch_step_mask
    from repro_torch.core.server import sample_devices
    from repro_torch.data.batching import stack_device_batches
    from repro_torch.kernels import (build, codec, dane_update,
                                     flash_attention, flatpack, local_solve,
                                     ref, selective_scan, xlstm_scan)
    from repro_torch.kernels import ops as kops
    from repro_torch.data.leaf_like import SENT_VOCAB, SHAKES_VOCAB
    from repro_torch.models.small import charlstm_specs, sentlstm_specs

    dev = syn.device
    rng = np.random.default_rng(1234)
    eta, mu, C, E = 0.01, 0.001, 10, PAPER["local_epochs"]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def normal(*shape, scale=1.0):
        return t((scale * rng.normal(size=shape)).astype(np.float32))

    # one masked device, as a straggler leaves one in the stacked round
    mask = t(np.array([1, 1, 1, 0, 1, 1, 1, 1, 1, 1], np.float32))
    active = int(mask.sum())

    # the first round's solve selection of a run on ``ds``
    def first_solve_batches(ds):
        r = np.random.default_rng(PAPER["seed"])
        sample_devices(r, ds.num_devices, 10, p=ds.weights)
        return stack_device_batches(
            ds, sample_devices(r, ds.num_devices, 10, p=ds.weights))

    def case(label, kernel, plain, tol, nbytes, flops, calls=100,
             plain_repeats=5, library=None, rtol=0.0,
             peak_flops=PEAK_F32_FLOPS, device_time=False, scaled=False,
             plain_calls=None, plain_once=False, each=False):
        """``scaled``: ``tol`` is relative to the plain output's max |y|
        (``each``: to each output's own max, each output held to its
        own); ``plain_calls``: calls a timed repeat of the plain version
        (by default ``calls``); ``plain_once``: the plain version runs
        once, its comparison call timed with CUDA events (a step loop of
        seconds at S=4096)."""
        got = kernel()
        if plain_once:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            want = plain()
            end.record()
            end.synchronize()
            once_ms = start.elapsed_time(end)
        else:
            want = plain()
        if each:
            for i, (x, y) in enumerate(zip(pt.leaves(got), pt.leaves(want))):
                top = float(y.float().abs().max())
                e = float((x.float() - y.float()).abs().max())
                check(e <= tol * top, f"{label}: output {i} differs by {e} "
                                      f"> {tol:g} x its max {top}")
        if scaled:
            tol = tol * max(float(y.float().abs().max())
                            for y in pt.leaves(want))
        err = max_err(torch, got, want)
        # |kernel - plain| <= tol + rtol * |plain|, elementwise
        excess = max(float(((x.float() - y.float()).abs()
                            - rtol * y.float().abs()).max())
                     for x, y in zip(pt.leaves(got), pt.leaves(want)))
        check(excess <= tol, f"{label}: error {err} exceeds atol {tol} + "
                             f"rtol {rtol} x |plain|")
        b_ms, b_by = bound(nbytes, flops, peak_flops)
        c = dict(shape=label, max_abs_err=err, tol=tol, rtol=rtol,
                 ms=cuda_ms(torch, kernel, calls),
                 plain_ms=once_ms if plain_once else cuda_ms(
                     torch, plain, plain_calls or calls,
                     repeats=plain_repeats),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=(cuda_ms(torch, library, calls)
                             if library is not None else None))
        lib = (f"  library {c['library_ms']:.4f} ms"
               if library is not None else "")
        if device_time:
            # the launch alone, without the host's part of a call
            c["device_ms"] = graph_ms(torch, kernel, calls)
            lib += (f"  device (graph of {calls}): kernel "
                    f"{c['device_ms']:.5f} ms")
            if library is not None:
                c["library_device_ms"] = graph_ms(torch, library, calls)
                lib += f", library {c['library_device_ms']:.5f} ms"
        print(f"  {label:52s} err {err:.3g} (tol {tol:g}, rtol {rtol:g})  kernel "
              f"{c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms{lib}  bound "
              f"{b_ms:.6f} ms ({b_by})")
        return c

    def row(name, replaces, source, cases):
        return dict(cases[0], name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=f"src/repro/kernels/{replaces}",
                    max_abs_err=max(c["max_abs_err"] for c in cases),
                    cases=cases)

    def row_bwd(cases):
        """K7's backward: a kernel of the port with no TPU counterpart
        (the reference differentiates its XLA attention, never K7)."""
        return dict(row("flash_attention_bwd", "", "flash_attention_bwd.cu",
                        cases),
                    replaces="none: no TPU kernel (the reference trains "
                             "through its XLA attention, "
                             "src/repro/models/attention.py:232)")

    def update_bytes(per_dev):
        """A masked step's bytes: an active device reads w, g, c, a and
        writes out; a masked one reads w and writes it; the mask once."""
        K = mask.numel()
        return 4 * (per_dev * (5 * active + 2 * (K - active)) + K)

    def k1_case(R):
        """One flat-mode step over K devices of R rows of 128 lanes."""
        K = mask.numel()
        w, g, c, a = (normal(K * R, 128) for _ in range(4))
        return case(
            f"dane_update_flat ({K * R}, 128) f32, 1 of {K} masked",
            lambda: dane_update.dane_update_flat(w, g, c, a, eta, mu, mask,
                                                 R),
            lambda: ref.dane_update_flat_ref(w, g, c, a, eta, mu, mask, R),
            UPDATE_TOL, update_bytes(R * 128), 6 * R * 128 * active,
            device_time=True)

    def k4_case(n, leaf):
        """The unmasked launch on a K-stacked leaf's (rows, 128) view."""
        w, g, c, a = (normal(-(-n // 128), 128) for _ in range(4))
        return case(
            f"dane_update_2d ({w.shape[0]}, 128) f32, the {leaf} leaf",
            lambda: dane_update.dane_update_2d(w, g, c, a, eta, mu),
            lambda: ref.dane_update_ref(w, g, c, a, eta=eta, mu=mu),
            UPDATE_TOL, 5 * 4 * w.numel(), 6 * w.numel(), device_time=True)

    # the synthetic model stacked over the K devices, as the per_leaf and
    # flat solver modes hold it; the step mask a strided column of a
    # (K, nb) table, as the solver hands it over
    K = mask.numel()
    table = torch.ones(K, 4, device=dev)
    table[:, 1] = mask
    col = table[:, 1]

    def tree(scale=1.0, stacked=True):
        lead = (K,) if stacked else ()
        return {"w": normal(*lead, 60, C, scale=scale),
                "b": normal(*lead, C, scale=scale)}

    wt, gt, ct, w0t = tree(0.1), tree(), tree(0.01), tree(0.1, False)
    at = pt.tmap(lambda x: x.expand((K,) + x.shape).contiguous(), w0t)
    per_dev = 60 * C + C

    def k4_tree_case(label, args, per_dev):
        """The per_leaf step's launch: every leaf of ``args`` (the w, g,
        c and anchor leaves, K-stacked), masked, at once -- one launch."""
        before = build.launch_counts["dane_update_2d"]
        dane_update.dane_update_leaves(*args, eta, mu, col)
        launches = build.launch_counts["dane_update_2d"] - before
        check(launches == 1, f"K4 took {launches} launches for the "
                             f"{len(args[0])} leaves of {label}")
        return case(
            f"dane_update_leaves {label} f32, 1 of {K} masked",
            lambda: dane_update.dane_update_leaves(*args, eta, mu, col),
            lambda: ref.dane_update_leaves_ref(*args, eta, mu, col),
            UPDATE_TOL, update_bytes(per_dev), 6 * per_dev * active,
            device_time=True)

    def path_case(label, kernel, plain, fn, nbytes, flops, counter):
        """One local step's whole update path (``fn``), held to ``plain``
        and timed like a kernel, with the device activities a step puts
        on the card (``torch.profiler``) and the launches it counts."""
        before = build.launch_counts[counter]
        fn()
        launches = build.launch_counts[counter] - before
        c = case(label, kernel, plain, UPDATE_TOL, nbytes, flops,
                 device_time=True)
        c.update(kernels_a_step=kernels_per_call(torch, fn),
                 launches_a_step=launches)
        print(f"    a step: {c['kernels_a_step']} kernels on the card, "
              f"{launches} {counter}")
        return c

    def per_leaf_path_case():
        """ops.dane_update_masked, the per_leaf solver's update a step."""
        def fn():
            return kops.dane_update_masked(wt, gt, ct, at, eta, mu, col)
        c = path_case(
            f"per_leaf step's update path, 1 of {K} masked", fn,
            lambda: ref.dane_update_leaves_ref(
                *(pt.leaves(x) for x in (wt, gt, ct, at)), eta, mu, col),
            fn, update_bytes(per_dev), 6 * per_dev * active,
            "dane_update_2d")
        check(c["launches_a_step"] == 1 and c["kernels_a_step"] == 1,
              f"the per_leaf step took {c['launches_a_step']} launches, "
              f"{c['kernels_a_step']} kernels")
        return c

    def flat_path_case(R):
        """ops.FlatUpdate.step, the flat solver's update a step (pack g,
        K1, the views of w), against packing w and g anew and the plain
        K1; the bytes count the g pack's copy too."""
        spec = flatpack.flat_spec(w0t)
        first = kops.FlatUpdate(spec, ct, w0t, K)
        upd = kops.FlatUpdate(spec, ct, w0t, K)

        def plain():
            return flatpack.unpack_stacked(spec, ref.dane_update_flat_ref(
                flatpack.pack_stacked(spec, at, K),
                flatpack.pack_stacked(spec, gt, K), first.corr,
                first.anchor, eta, mu, col, R), K)
        c = path_case(
            f"flat step's update path ({K * R}, 128), 1 of {K} masked",
            lambda: first.step(gt, eta, mu, col), plain,
            lambda: upd.step(gt, eta, mu, col),
            update_bytes(R * 128) + 8 * K * per_dev, 6 * R * 128 * active,
            "dane_update_flat")
        check(c["launches_a_step"] == 1 and c["kernels_a_step"] is not None
              and c["kernels_a_step"] <= 3,
              f"the flat step took {c['kernels_a_step']} kernels")
        return c

    # K2 in its global tier at shapes its shared tier takes: the times of
    # both tiers on the same inputs (appended to K2's row)
    global_at_shared = []

    def epoch_case(batches, step_mask, what="", both_tiers=False):
        """The whole E-epoch solve of ``batches`` under ``step_mask`` from
        a numpy-seeded anchor and correction; ``both_tiers``: also in K2's
        global tier, forced, on the same inputs."""
        K, nb, B, d = batches["x"].shape
        w0 = {"w": normal(d, C, scale=0.1), "b": normal(C, scale=0.1)}
        corr = {"w": normal(K, d, C, scale=0.01),
                "b": normal(K, C, scale=0.01)}
        # bytes: each batch some kept step reads, the correction of each
        # device with a kept step, the anchor, the step table, the output
        used = (step_mask.reshape(K, E, nb) > 0).any(dim=1)
        dC = d * C + C
        nbytes = 4 * (int(used.sum()) * B * (d + 1)
                      + int(used.any(dim=1).sum()) * dC + dC + K * E * nb
                      + K * dC)
        steps = float(step_mask.sum())
        flops = steps * (4 * B * d * C + 8 * B * C + 6 * dC)
        def solve_case(label):
            return case(
                f"local_epoch K={K} nb={nb} B={B} d={d} E={E} "
                f"steps={int(steps)}{label}",
                lambda: local_solve.local_epoch(
                    w0, corr, batches, eta=eta, mu=mu, num_epochs=E,
                    step_mask=step_mask),
                lambda: ref.local_epoch_ref(
                    w0, corr, batches, eta=eta, mu=mu, num_epochs=E,
                    step_mask=step_mask),
                EPOCH_TOL, nbytes, flops, calls=1, plain_repeats=2)

        c = solve_case(what)
        if both_tiers:
            assert local_solve.epoch_tier(d, C, B) == "shared"
            pick = local_solve.epoch_tier
            local_solve.epoch_tier = lambda d, C, B: "global"
            try:
                global_at_shared.append(solve_case(what + ", global tier"))
            finally:
                local_solve.epoch_tier = pick
        return c

    def k2_case(ds, k=None, work=None, what="", both_tiers=False):
        """The whole E-epoch solve of the first selection: its padding
        steps masked and one device masked out entirely.  ``k``: only
        its first k devices, at the whole cohort's batch count, as a
        rank of the mesh solves them; ``work``: each device stops after
        ``ceil(work * its steps)`` steps, as a scenario's work cutoff
        truncates the solve."""
        batches, valid = first_solve_batches(ds)
        valid = valid.clone()
        valid[3] = 0.0
        if k is not None:
            batches = {n: x[:k].contiguous() for n, x in batches.items()}
            valid = valid[:k].contiguous()
        limit = None
        if work is not None:
            total = E * valid.sum(dim=1)
            limit = torch.minimum(torch.ceil(work * total), total)
        return epoch_case(batches, _epoch_step_mask(valid, E, limit)
                          .contiguous(), what, both_tiers)

    def wide_solve(d, K=10, nb=16, B=10):
        """Numpy-seeded stacked batches of a model past K2's shared tier:
        device k keeps its first nb - k % 3 batches (padding steps
        masked), device 3 none."""
        x = normal(K, nb, B, d)
        y = t(rng.integers(0, C, (K, nb, B)).astype(np.int32))
        valid = np.zeros((K, nb), np.float32)
        for j in range(K):
            valid[j, :nb - j % 3] = 1.0
        valid[3] = 0.0
        return {"x": x, "y": y}, t(valid)

    def k2_wide_case(d):
        batches, valid = wide_solve(d)
        assert local_solve.epoch_tier(d, C, batches["x"].shape[2]) == \
            "global"
        return epoch_case(batches, _epoch_step_mask(valid, E).contiguous(),
                          ", numpy-seeded, global tier")

    def k3_case(fb, k=None, what=""):
        """One step on a [:, j] slice of the stacked batches ``fb``, as
        the fused_step mode hands it over, with one device masked;
        ``k``: the first k devices only (a buffered refill; the masked
        one among them from k = 4)."""
        m = mask if k is None else mask[:k].contiguous()
        active = int(m.sum())
        batch = {"x": fb["x"][:k, 0], "y": fb["y"][:k, 0]}
        K, B, d = batch["x"].shape
        wk = {"w": normal(K, d, C, scale=0.1), "b": normal(K, C, scale=0.1)}
        w0 = {"w": normal(d, C, scale=0.1), "b": normal(C, scale=0.1)}
        corr = {"w": normal(K, d, C, scale=0.01),
                "b": normal(K, C, scale=0.01)}
        # bytes: every device reads w and writes out; an active one also
        # reads its batch and correction; the anchor and mask once
        dC = d * C + C
        nbytes = 4 * (2 * K * dC + active * (B * (d + 1) + dC) + dC + K)
        flops = active * (4 * B * d * C + 8 * B * C + 6 * dC)
        return case(
            f"linear_logistic_step K={K} B={B} d={d}{what}",
            lambda: local_solve.linear_logistic_step(
                wk, batch, corr, w0, eta=eta, mu=mu, mask=m),
            lambda: ref.linear_logistic_step_ref(
                wk, batch, corr, w0, eta=eta, mu=mu, mask=m),
            STEP_TOL, nbytes, flops)

    def k5_case(R, m, what):
        """The cohort aggregate over K clients of R rows of 128 lanes,
        as the codec round gives it: int8-like code points with per-
        client scales.  Only the active clients' slabs are read."""
        K = m.numel()
        vals = t(np.floor(rng.uniform(-127, 128, (K, R, 128))).astype(
            np.float32))
        scales = t(rng.uniform(1e-4, 1e-3, K).astype(np.float32))
        n_act = int(m.sum())
        nbytes = 4 * (n_act * R * 128 + R * 128 + 2 * K)
        flops = 2 * n_act * R * 128 + R * 128
        w = scales * m
        w_over = w / torch.clamp(m.sum(), min=1.0)
        label = f"codec_aggregate ({K}, {R}, 128) f32, {what}"
        c = case(label, lambda: codec.codec_aggregate(vals, scales, m),
                 lambda: ref.codec_aggregate_ref(vals, scales, m),
                 CODEC_TOL, nbytes, flops,
                 library=lambda: torch.einsum("k,krl->rl", w_over, vals),
                 device_time=True)
        if n_act == 0:
            out = codec.codec_aggregate(vals, scales, m)
            check(bool((out == 0).all()) and not bool(
                torch.signbit(out).any()),
                f"{label}: an all-inactive cohort must give +0.0")
        return c

    def k6_case(R, m, what):
        """One rank's partial sum over its K/D clients of R rows of 128
        lanes, as the mesh's codec round gives it.  Only the active
        clients' slabs are read."""
        K = m.numel()
        vals = t(np.floor(rng.uniform(-127, 128, (K, R, 128))).astype(
            np.float32))
        scales = t(rng.uniform(1e-4, 1e-3, K).astype(np.float32))
        n_act = int(m.sum())
        nbytes = 4 * (n_act * R * 128 + R * 128 + 2 * K)
        flops = 2 * n_act * R * 128
        w = scales * m
        label = f"codec_aggregate_partial ({K}, {R}, 128) f32, {what}"
        c = case(label,
                 lambda: codec.codec_aggregate_partial(vals, scales, m),
                 lambda: ref.codec_aggregate_partial_ref(vals, scales, m),
                 CODEC_TOL, nbytes, flops,
                 library=lambda: torch.einsum("k,krl->rl", w, vals),
                 device_time=True)
        if n_act == 0:
            out = codec.codec_aggregate_partial(vals, scales, m)
            check(bool((out == 0).all()) and not bool(
                torch.signbit(out).any()),
                f"{label}: an all-inactive slab must give +0.0")
        return c

    def k7_case(label, bh, s, t_len, hd, causal, dtype, period=0,
                gqa=None, calls=5, lse=False):
        """K7 on numpy-seeded ``(bh, s|t_len, hd)`` inputs.  ``gqa``:
        ``(B, H, Kv)`` when the rows are GQA-folded in the model's order
        (each slice's G*S rows are G query heads of one KV head), which
        is how SDPA's ``enable_gqa`` takes them as (B, H, S, hd)."""
        tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
        q = normal(bh, s, hd).to(tdt)
        k = normal(bh, t_len, hd).to(tdt)
        v = normal(bh, t_len, hd).to(tdt)
        # the visible (query, key) pairs: each costs 4*hd flops
        pos = torch.arange(s)
        pos = pos % period if period else pos
        pairs = bh * (int(torch.clamp(pos + 1, max=t_len).sum()) if causal
                      else s * t_len)
        nbytes = q.element_size() * bh * hd * (2 * s + 2 * t_len)
        heads = (1, bh) if gqa is None else (gqa[0], gqa[1])
        q4 = q.view(heads[0], heads[1], -1, hd)
        k4 = k.view(heads[0], -1, t_len, hd)
        v4 = v.view(heads[0], -1, t_len, hd)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        atol, rtol = FLASH_TOL[dtype]
        return case(
            f"flash_attention_3d ({bh}, {s}, {hd}) x T={t_len} {dtype}, "
            f"{label}",
            lambda: flash_attention.flash_attention_3d_fwd(
                q, k, v, causal=causal, causal_period=period,
                with_lse=lse)[0],
            lambda: ref.flash_attention_3d_ref(
                q, k, v, causal=causal, causal_period=period),
            atol, nbytes, 4 * hd * pairs, calls=calls, plain_repeats=3,
            rtol=rtol,
            peak_flops=PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_TF32_FLOPS,
            library=lambda: sdpa(q4, k4, v4, is_causal=causal,
                                 enable_gqa=gqa is not None))

    def k7_bwd_case(label, bh, s, t_len, hd, dtype, period=0, gqa=None,
                    calls=5, causal=True):
        """The K7 backward on numpy-seeded ``(bh, s|t_len, hd)`` inputs
        and cotangent, causal or not, from the forward kernel's lse: held
        to the explicit formula on the card (the worst of dq, dk and dv);
        its bound is 5 products of 2*hd flops a visible pair; the
        library call is ``torch.autograd.grad`` through SDPA (its
        backward alone, the forward recorded once)."""
        tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
        q = normal(bh, s, hd).to(tdt)
        k = normal(bh, t_len, hd).to(tdt)
        v = normal(bh, t_len, hd).to(tdt)
        do = normal(bh, s, hd).to(tdt)
        o, lse = flash_attention.flash_attention_3d_fwd(
            q, k, v, causal=causal, causal_period=period, with_lse=True)
        pos = torch.arange(s)
        pos = pos % period if period else pos
        pairs = bh * (int(torch.clamp(pos + 1, max=t_len).sum()) if causal
                      else s * t_len)
        # q, k, v, o, dO and lse read once; dq, dk, dv written once
        nbytes = q.element_size() * bh * hd * (4 * s + 4 * t_len) \
            + 4 * bh * s
        heads = (1, bh) if gqa is None else (gqa[0], gqa[1])
        q4 = q.view(heads[0], heads[1], -1, hd).detach().requires_grad_(True)
        k4, v4 = (x.view(heads[0], -1, t_len, hd).detach().requires_grad_(
            True) for x in (k, v))
        out4 = torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=gqa is not None)
        do4 = do.view(out4.shape)
        atol, rtol = FLASH_TOL[dtype]
        name = (f"flash_attention_3d_bwd ({bh}, {s}, {hd}) x T={t_len} "
                f"{dtype}, {label}")

        def kernel():
            return flash_attention.flash_attention_3d_bwd(
                q, k, v, o, do, lse, causal=causal, causal_period=period)

        # no atomics, the split walk's parts summed in a fixed order: a
        # second call gives the first one's bits (phase 11's flat ==
        # per_leaf round rests on it)
        first, second = kernel(), kernel()
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"{name}: a second call differs from the first")
        del first, second
        return case(
            name, kernel,
            lambda: ref.flash_attention_3d_bwd_ref(
                q, k, v, o, do, lse, causal=causal, causal_period=period),
            atol, nbytes, 10 * hd * pairs, calls=calls, plain_repeats=3,
            rtol=rtol,
            peak_flops=PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_TF32_FLOPS,
            library=lambda: torch.autograd.grad(out4, (q4, k4, v4), do4,
                                                retain_graph=True))

    def k8_case(label, B, S, di, N, calls=20):
        """K8 on numpy-seeded inputs shaped as the mixer makes them (dt a
        softplus, A = -exp(a_log) with a random a_log: the model's zeros
        would make A -1 everywhere), held within K8_REL x max |y| of
        the plain step loop on the card.  Its bound: x, dt, Bc, Cc, A
        read once and y written once, against the B*S*di*N exponentials
        on the special-function units (the state's 6 f32 flops each,
        at 67 TFLOP/s, take less); no PyTorch call computes the scan."""
        x, bc, cc = (normal(B, S, n) for n in (di, N, N))
        dt = torch.nn.functional.softplus(normal(B, S, di) - 1.0)
        a = -torch.exp(normal(di, N, scale=0.5))
        nbytes = 4 * (3 * B * S * di + 2 * B * S * N + di * N)
        return case(
            f"selective_scan ({B}, {S}, {di}) N={N} f32, {label}",
            lambda: selective_scan.selective_scan(x, dt, bc, cc, a),
            lambda: ref.selective_scan_ref(x, dt, bc, cc, a),
            K8_REL, nbytes, B * S * di * N, calls=calls, plain_once=True,
            peak_flops=PEAK_SFU_OPS, scaled=True)

    def row_k8(cases):
        """K8: a kernel of the port with no TPU counterpart (the
        reference's scan is a ``lax.scan`` that XLA loops)."""
        return dict(row("selective_scan", "", "selective_scan.cu", cases),
                    replaces="none: no TPU kernel (the reference scans "
                             "_mamba_step with lax.scan, "
                             "src/repro/models/ssm.py:99-108 under "
                             "chunked_scan :26-41)")

    def k8_bwd_case(label, B, S, di, N, groups=0, calls=20):
        """K8-bwd on numpy-seeded inputs shaped as K8's (``groups``: A one
        a group of batch rows, as the vmap fold of ``groups`` clients
        gives it) and a cotangent, from the states K8's training launch
        saved: each output within GRAD_REL x its own max |g| of the
        plain backward on the same inputs (which runs once, its call
        timed), two calls bitwise equal; the
        training launch's y and H within K8_REL x their max of the plain
        forward's (H is all 0 at S <= 64: then equal).  Its bound: x, dt,
        dy, Bc, Cc, A and H read once, dx, ddt, dBc, dCc and dA written
        once, against the B*S*di*N exponentials exp(dt_t A) the gradient
        needs on the special-function units (the kernel evaluates each
        twice, in the chunk's recomputation and its walk back: its own
        choice); no PyTorch call computes the scan's gradient."""
        x, bc, cc, dy = (normal(B, S, n) for n in (di, N, N, di))
        dt = torch.nn.functional.softplus(normal(B, S, di) - 1.0)
        a = -torch.exp(normal(*((groups,) if groups else ()), di, N,
                              scale=0.5))
        y, H = selective_scan.selective_scan_fwd(x, dt, bc, cc, a,
                                                 with_states=True)
        for name, g, w in zip(("y", "H"), (y, H), ref.selective_scan_fwd_ref(
                x, dt, bc, cc, a, selective_scan.CHUNK)):
            err, top = float((g - w).abs().max()), float(w.abs().max())
            check(err <= K8_REL * top, f"K8 {label}: the training launch's "
                                       f"{name} differs from the plain "
                                       f"forward's by {err} (max {top})")
        del y
        args = (x, dt, bc, cc, a, H, dy)
        bitwise_all(f"K8-bwd {label}", selective_scan.selective_scan_bwd,
                    *args)
        nbytes = 4 * (5 * B * S * di + 4 * B * S * N + 2 * a.numel()
                      + H.numel())
        return case(
            f"selective_scan_bwd ({B}, {S}, {di}) N={N} f32"
            + (f" A in {groups} groups" if groups else "") + f", {label}",
            lambda: selective_scan.selective_scan_bwd(*args),
            lambda: ref.selective_scan_bwd_ref(*args),
            GRAD_REL, nbytes, B * S * di * N, calls=calls, plain_once=True,
            peak_flops=PEAK_SFU_OPS, scaled=True, each=True)

    def row_k8_bwd(cases):
        """K8-bwd: a kernel of the port with no TPU counterpart (the
        reference differentiates its lax.scan under jax.checkpoint)."""
        return dict(row("selective_scan_bwd", "", "selective_scan_bwd.cu",
                        cases),
                    replaces="none: no TPU kernel (the reference "
                             "differentiates its lax.scan of _mamba_step "
                             "under chunked_scan's jax.checkpoint, "
                             "src/repro/models/ssm.py:26-41)")

    def bitwise_case(what, kernel, *args):
        """Two calls of ``kernel`` on the same inputs give the same bits."""
        check(torch.equal(kernel(*args), kernel(*args)),
              f"{what}: two calls differ")

    def bitwise_all(what, kernel, *args):
        """Two calls of ``kernel`` on the same inputs give the same bits
        in every output."""
        check(all(torch.equal(a, b) for a, b in zip(kernel(*args),
                                                    kernel(*args))),
              f"{what}: two calls differ")

    def k9_case(label, B, S, H, D, calls=20):
        """K9 on numpy-seeded inputs (q, k, v and log_i of O(1), log_f a
        log-sigmoid of N(2, 1)), within XLSTM_REL x max |h| of the plain
        step loop on the card, two calls bitwise equal.  Its bound: q, k,
        v and the gates read once, h written once, against the 5 flops an
        element of C a step (C f + (i k) v, and the sum of C q) and the
        8 a row of n; no PyTorch call computes the scan."""
        q, k, v = (normal(B, S, H, D) for _ in range(3))
        log_i = normal(B, S, H)
        log_f = ref.logsigmoid(normal(B, S, H) + 2.0)
        args = (q, k, v, log_i, log_f)
        bitwise_case(f"K9 {label}", xlstm_scan.mlstm_scan, *args)
        nbytes = 4 * (4 * B * S * H * D + 2 * B * S * H)
        return k9_plan(case(
            f"mlstm_scan ({B}, {S}, {H}, {D}) f32, {label}",
            lambda: xlstm_scan.mlstm_scan(*args),
            lambda: ref.mlstm_scan_ref(*args),
            XLSTM_REL, nbytes, B * S * H * (5 * D * D + 8 * D), calls=calls,
            plain_once=True, scaled=True), S, D, bwd=False)

    def k9_plan(c, S, D, bwd):
        """A K9 or K9-bwd case with its time a step and its plan
        (``xlstm_scan.mlstm_plan``); K9-bwd's with how many of its walk's
        clusters fit the card at once."""
        plan = xlstm_scan.mlstm_plan(D)
        c.update(us_per_step=c["ms"] * 1e3 / S, plan=plan._asdict())
        if bwd:
            c["resident_clusters"] = xlstm_scan.mlstm_resident_clusters(D)
            print(f"      {c['us_per_step']:.4f} us a step; walk blocks of "
                  f"{plan.cols} columns x {plan.threads} threads, "
                  f"sub-chunks of {plan.sub} steps, clusters of "
                  f"{plan.cluster} ({c['resident_clusters']} resident at "
                  f"once), {plan.shared_bytes} B of shared memory a block; "
                  f"the second recompute's flops, beyond the bound: "
                  f"{c['design_overhead_ms']:.4f} ms")
        else:
            print(f"      {c['us_per_step']:.4f} us a step; blocks of "
                  f"{plan.fwd_cols} columns x {plan.fwd_threads} threads, "
                  f"tiles of {plan.fwd_tile} steps, "
                  f"{plan.fwd_shared_bytes} B of shared memory a block")
        return c

    def k10_case(label, B, S, H, D, calls=5):
        """K10 on numpy-seeded inputs (zx, ix, fx, ox of O(1), the
        recurrent matrices at the model's scale 0.02), within XLSTM_REL x
        max |h| of the plain step loop on the card, two calls bitwise
        equal.  Its bound: the inputs and the four (H, D, D) matrices read
        once, h written once, against the 4 products of h with a matrix a
        step (2 D^2 flops each a head) and ~30 flops an element for the
        gates; no PyTorch call computes the scan."""
        xs = [normal(B, S, H, D) for _ in range(4)]
        rs = [normal(H, D, D, scale=0.02) for _ in range(4)]
        args = tuple(xs + rs)
        bitwise_case(f"K10 {label}", xlstm_scan.slstm_scan, *args)
        nbytes = 4 * (5 * B * S * H * D + 4 * H * D * D)
        return k10_plan(case(
            f"slstm_scan ({B}, {S}, {H}, {D}) f32, {label}",
            lambda: xlstm_scan.slstm_scan(*args),
            lambda: ref.slstm_scan_ref(*args),
            XLSTM_REL, nbytes, B * S * H * D * (8 * D + 30), calls=calls,
            plain_once=True, scaled=True), S, D, "serve")

    def k10_plan(c, S, D, kind):
        """A K10 or K10-bwd case with its time a step, its cluster and how
        many of its clusters fit the card at once."""
        plan = xlstm_scan.slstm_plan(D)
        c.update(us_per_step=c["ms"] * 1e3 / S, cluster=plan.cluster,
                 resident_clusters=xlstm_scan.slstm_resident_clusters(D,
                                                                      kind))
        print(f"      {c['us_per_step']:.4f} us a step; clusters of "
              f"{plan.cluster} x {plan.threads} threads, "
              f"{c['resident_clusters']} resident at once")
        return c

    def row_xlstm(name, source, step, cases):
        """K9 or K10: a kernel of the port with no TPU counterpart (the
        reference's scan is a ``lax.scan`` that XLA loops)."""
        return dict(row(name, "", source, cases),
                    replaces=f"none: no TPU kernel (the reference scans "
                             f"{step} with lax.scan under chunked_scan)")

    def k9_bwd_case(label, B, S, H, D, calls=5):
        """K9-bwd on K9's inputs (as :func:`k9_case`) and a cotangent, from
        the states K9's training launch saved: the training launch's h
        and chunk states within XLSTM_REL x their max of the plain
        forward's (C, n at chunk 0 are zeros: then equal); each output
        within GRAD_REL x its own max |g| of the plain backward (which
        runs once, its call timed), two calls bitwise equal.  Its bound:
        q, k, v, h, dh, the gates and the saved states read once, dq,
        dk, dv and the gates' gradients written once, against the 14
        flops an element of C a step that the function needs (the
        recurrence recomputed once, 3, and the walk's five products with
        dC, 11) at 67 TFLOP/s.  The kernel recomputes the recurrence
        twice (once for the sub-chunks' starts, once into shared
        memory): that third product, 3 flops more, is its design's own
        overhead, reported apart (``design_overhead_ms``).  No PyTorch
        call computes the scan's gradient."""
        q, k, v, dh = (normal(B, S, H, D) for _ in range(4))
        log_i = normal(B, S, H)
        log_f = ref.logsigmoid(normal(B, S, H) + 2.0)
        gates = (q, k, v, log_i, log_f)
        out = xlstm_scan.mlstm_scan_fwd(*gates, with_states=True)
        for name, g, w in zip(("h", "C", "n", "m"), out,
                              ref.mlstm_scan_fwd_ref(*gates)):
            err, top = float((g - w).abs().max()), float(w.abs().max())
            check(err <= XLSTM_REL * top, f"K9 {label}: the training "
                                          f"launch's {name} differs from "
                                          f"the plain forward's by {err} "
                                          f"(max {top})")
        args = gates + out + (dh,)
        bitwise_all(f"K9-bwd {label}", xlstm_scan.mlstm_scan_bwd, *args)
        nc = -(-S // 64)
        nbytes = 4 * (8 * B * S * H * D + 4 * B * S * H
                      + B * nc * H * (D * D + D + 1))
        c = case(f"mlstm_scan_bwd ({B}, {S}, {H}, {D}) f32, {label}",
                 lambda: xlstm_scan.mlstm_scan_bwd(*args),
                 lambda: ref.mlstm_scan_bwd_ref(*args),
                 GRAD_REL, nbytes, 14 * B * S * H * D * D, calls=calls,
                 plain_once=True, scaled=True, each=True)
        c["design_overhead_ms"] = 3 * B * S * H * D * D / PEAK_F32_FLOPS * 1e3
        return k9_plan(c, S, D, bwd=True)

    def k10_bwd_case(label, B, S, H, D, groups=0, calls=5):
        """K10-bwd on K10's inputs (as :func:`k10_case`; ``groups``: the
        r's one a group of batch rows, as the vmap fold of ``groups``
        clients gives them) and a cotangent, from every step's states
        K10's training launch saved: the training launch's h and states
        within XLSTM_REL x their max of the plain forward's; each output
        within GRAD_REL x its own max |g| of the plain backward (which
        runs once, its call timed), two calls bitwise equal.  Its bound:
        the 7 saved states, h and dh read once, the 4 input gradients
        written once, the r's read and their gradients written once,
        against the 4 products r_g d_g a step and the 4 of dr (2 dh^2
        flops each a head) and ~40 flops an element for the gates'
        derivatives, at 67 TFLOP/s; no PyTorch call computes the scan's
        gradient."""
        xs = [normal(B, S, H, D) for _ in range(4)]
        rs = [normal(*((groups,) if groups else ()), H, D, D, scale=0.02)
              for _ in range(4)]
        dh = normal(B, S, H, D)
        out = xlstm_scan.slstm_scan_fwd(*xs, *rs, with_states=True)
        for name, g, w in zip(("h",) + ref.SLSTM_STATES, out,
                              ref.slstm_scan_fwd_ref(*xs, *rs)):
            err, top = float((g - w).abs().max()), float(w.abs().max())
            check(err <= XLSTM_REL * top, f"K10 {label}: the training "
                                          f"launch's {name} differs from "
                                          f"the plain forward's by {err} "
                                          f"(max {top})")
        args = tuple(rs) + out + (dh,)
        bitwise_all(f"K10-bwd {label}", xlstm_scan.slstm_scan_bwd, *args)
        nbytes = 4 * (13 * B * S * H * D + 8 * rs[0].numel())
        return k10_plan(case(
            f"slstm_scan_bwd ({B}, {S}, {H}, {D}) f32"
            + (f" r in {groups} groups" if groups else "") + f", {label}",
            lambda: xlstm_scan.slstm_scan_bwd(*args),
            lambda: ref.slstm_scan_bwd_ref(*args),
            GRAD_REL, nbytes, B * S * H * D * (16 * D + 40), calls=calls,
            plain_once=True, scaled=True, each=True), S, D, "bwd")

    def row_xlstm_bwd(name, source, step, cases):
        """K9-bwd or K10-bwd: a kernel of the port with no TPU counterpart
        (the reference differentiates its lax.scan under jax.checkpoint)."""
        return dict(row(name, "", source, cases),
                    replaces=f"none: no TPU kernel (the reference "
                             f"differentiates its lax.scan of {step} under "
                             f"chunked_scan's jax.checkpoint, "
                             f"src/repro/models/ssm.py:26-41)")

    def qwen_update_cases():
        """K1 over the trainer's qwen1.5-0.5b flat pack (LM_TRAIN_K
        devices, all active, as a local step's mask) and K4 over the
        stacked qwen tree's leaves in one launch, on inputs from a
        seeded card generator (numpy would take minutes for ~10^9
        draws); no device-time graph (each call allocates its output)."""
        from repro_torch.configs import get_arch
        from repro_torch.models import model_specs
        Kq = LM_TRAIN_K
        gen = torch.Generator(device=dev).manual_seed(23)
        specs = pt.leaves(model_specs(get_arch("qwen1.5-0.5b")))
        per = sum(int(np.prod(sp.shape)) for sp in specs)
        rows_q = flatpack.flat_spec(
            [torch.zeros(sp.shape, device="meta") for sp in specs]).rows
        on = torch.ones(Kq, device=dev)

        def randn(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=gen, device=dev)

        w, g, c, a = (randn(Kq * rows_q, 128, scale=sc)
                      for sc in (0.1, 1.0, 0.01, 0.1))
        out = [case(f"dane_update_flat ({Kq * rows_q}, 128) f32, the qwen "
                    f"pack, {Kq} devices",
                    lambda: dane_update.dane_update_flat(w, g, c, a, eta, mu,
                                                         on, rows_q),
                    lambda: ref.dane_update_flat_ref(w, g, c, a, eta, mu, on,
                                                     rows_q),
                    UPDATE_TOL, 4 * (5 * Kq * rows_q * 128 + Kq),
                    6 * Kq * rows_q * 128, calls=5, plain_repeats=1)]
        del w, g, c, a
        args = [[randn(Kq, *sp.shape, scale=sc) for sp in specs]
                for sc in (0.1, 1.0, 0.01, 0.1)]
        before = build.launch_counts["dane_update_2d"]
        dane_update.dane_update_leaves(*args, eta, mu, on)
        check(build.launch_counts["dane_update_2d"] - before == 1,
              f"K4 took more than one launch for the {len(specs)} qwen "
              f"leaves")
        out.append(case(
            f"dane_update_leaves qwen tree ({len(specs)} leaves, {per:,} a "
            f"device) f32, {Kq} devices",
            lambda: dane_update.dane_update_leaves(*args, eta, mu, on),
            lambda: ref.dane_update_leaves_ref(*args, eta, mu, on),
            UPDATE_TOL, 4 * (5 * Kq * per + Kq), 6 * Kq * per, calls=5,
            plain_repeats=1))
        del args
        torch.cuda.empty_cache()
        return out

    # The LSTMs of phase 8 at full width: the Sent140 model's flat pack
    # (480 rows a device) and the Shakespeare model's (6,392), and the
    # Shakespeare model's 9 leaves stacked over the K devices
    char_specs = pt.leaves(charlstm_specs(SHAKES_VOCAB))
    char_args = [[normal(K, *sp.shape, scale=sc) for sp in char_specs]
                 for sc in (0.1, 1.0, 0.01)]
    char_args.append([normal(*sp.shape, scale=0.1).expand(
        (K,) + sp.shape).contiguous() for sp in char_specs])
    char_per_dev = sum(x[0].numel() for x in char_args[0])

    # K1 runs on the synthetic model's flat pack (8 rows a device); K4 on
    # its two leaves, (K, 60, 10) and (K, 10); K2 on the auto path of both
    # datasets; K3 on both fused_step runs.
    rows_syn = flatpack.flat_spec({"w": torch.zeros(60, C),
                                   "b": torch.zeros(C)}).rows
    rows_fem = flatpack.flat_spec({"w": torch.zeros(784, C),
                                   "b": torch.zeros(C)}).rows
    none = torch.zeros_like(mask)
    qwen_k1, qwen_k4 = qwen_update_cases()
    rows = [
        row("dane_update_flat", "dane_update.py:62", "dane_update.cu",
            [k1_case(rows_syn), k1_case(rows_fem),
             flat_path_case(rows_syn),
             k1_case(lstm_rows(sentlstm_specs(SENT_VOCAB))),
             k1_case(lstm_rows(charlstm_specs(SHAKES_VOCAB))), qwen_k1]),
        row("dane_update_2d", "dane_update.py:27", "dane_update.cu",
            [k4_tree_case(f"{{w: ({K}, 60, {C}), b: ({K}, {C})}}",
                          [pt.leaves(x) for x in (wt, gt, ct, at)],
                          per_dev),
             k4_case(K * 60 * C, "w"), k4_case(K * C, "b"),
             per_leaf_path_case(),
             k4_tree_case(f"charlstm ({len(char_specs)} leaves, "
                          f"{char_per_dev:,} a device)", char_args,
                          char_per_dev), qwen_k4])]
    del char_args
    # K2 also on a rank's slab of the mesh: the flat mesh's 5 of 10
    # devices (the masked one among them), and the tree's one device a
    # rank with its solve cut short by the hostile scenario's work
    k2_cases = [k2_case(syn, both_tiers=True), k2_case(fem, both_tiers=True),
                k2_case(syn, k=5, what=", rows 0:5 (2-rank mesh)"),
                k2_case(syn, k=1, work=0.37,
                        what=", row 0, work 0.37 (10-rank tree, a "
                             "buffered refill)"),
                k2_case(syn, k=3, what=", rows 0:3 (a buffered refill)"),
                # past one block's shared memory: the global tier, at d up
                # to the reference's budget (B*d + 2*d*C <= 2^20 at C=B=10)
                k2_wide_case(2000), k2_wide_case(34952)]
    return rows + [
        row("local_epoch", "local_solve.py:168", "local_solve.cu",
            k2_cases + global_at_shared),
        row("linear_logistic_step", "local_solve.py:68", "local_solve.cu",
            [k3_case(first_solve_batches(fem)[0]),
             k3_case(first_solve_batches(syn)[0]),
             k3_case(first_solve_batches(syn)[0], k=1,
                     what=", a buffered refill of 1"),
             k3_case(first_solve_batches(syn)[0], k=3,
                     what=", a buffered refill of 3"),
             k3_case(wide_solve(2000, nb=1)[0]),
             k3_case(wide_solve(34952, nb=1)[0])]),
        # K5 on the synthetic flat pack (phase 7) and the FEMNIST-like one
        row("codec_aggregate", "codec.py:34", "codec.cu",
            [k5_case(rows_syn, mask, "1 of 10 masked"),
             k5_case(rows_fem, mask, "1 of 10 masked"),
             k5_case(rows_syn, none, "all 10 inactive")]),
        # K6 on a rank's slab: K=10 over the flat mesh's two ranks (the
        # masked client among them), one client a rank of the tree, the
        # FEMNIST-like pack, and a rank whose clients are all inactive
        row("codec_aggregate_partial", "codec.py:44", "codec.cu",
            [k6_case(rows_syn, mask[:5], "K=10 over 2 ranks, 1 masked"),
             k6_case(rows_syn, mask[:1], "one client a rank"),
             k6_case(rows_fem, mask[:2], "FEMNIST-like pack"),
             k6_case(rows_syn, none[:5], "all 5 inactive")]),
        # K7 at phase 10's prefill shapes, plus bf16, ragged and non-causal
        row("flash_attention", "flash_attention.py:24",
            "flash_attention.cu",
            [k7_case("qwen B=1 S=4096", 16, 4096, 4096, 64, True, "f32"),
             k7_case("qwen B=1 S=4096", 16, 4096, 4096, 64, True, "bf16"),
             k7_case("yi-9b B=1 S=2048 GQA-folded", 4, 8 * 2048, 2048, 128,
                     True, "f32", period=2048, gqa=(1, 32, 4)),
             k7_case("ragged", 16, 1000, 1000, 64, True, "f32"),
             k7_case("non-causal", 8, 512, 512, 64, False, "f32"),
             k7_case("qwen B=2 S=1024", 32, 1024, 1024, 64, True, "f32"),
             k7_case("qwen B=2 S=128", 32, 128, 128, 64, True, "f32",
                     calls=20),
             # phase 10's qwen3-moe prefills: 16 query heads a KV head,
             # folded into 16*S rows against S keys
             k7_case("(m) qwen3-moe B=1 S=4096 GQA-folded", 4, 16 * 4096,
                     4096, 64, True, "f32", period=4096, gqa=(1, 64, 4)),
             k7_case("(n) qwen3-moe B=2 S=1024 GQA-folded", 8, 16 * 1024,
                     1024, 64, True, "f32", period=1024, gqa=(2, 64, 4)),
             # phase 10c's jamba prefills: 32 query heads on 8 KV heads,
             # hd=128, folded into 4*S rows against S keys
             k7_case("(o) jamba B=1 S=4096 GQA-folded", 8, 4 * 4096, 4096,
                     128, True, "f32", period=4096, gqa=(1, 32, 8)),
             k7_case("(p) jamba B=2 S=1024 GQA-folded", 16, 4 * 1024, 1024,
                     128, True, "f32", period=1024, gqa=(2, 32, 8)),
             # phase 11's train step (S=4096) and the trainer's folded
             # launches (S=64): K*B*H rows of a local step, K*nb*B*H of
             # phase A's gradients
             k7_case("qwen train_4k B=1 S=4096, with lse",
                     16, 4096, 4096, 64, True, "f32", lse=True),
             k7_case(f"trainer, a local step (K={LM_TRAIN_K}, B=4, 16 "
                     f"heads), with lse", LM_TRAIN_K * 64, 64, 64, 64, True,
                     "f32", calls=20, lse=True),
             # phases 10e and 11e's whisper-tiny (6 heads of 64, no GQA):
             # the encoder at B=8 x 1,500 frames, cross-attention of 448
             # training tokens and of a prefill's BOS token against them
             k7_case("(q) whisper encoder B=8 T=1500", 48, 1500, 1500, 64,
                     False, "f32", period=1500),
             k7_case("(r) whisper cross-attention B=8 S=448", 48, 448, 1500,
                     64, False, "f32", period=448),
             k7_case("(r') whisper cross-attention, a prefill's BOS", 48, 1,
                     1500, 64, False, "f32", period=1, calls=20)]),
        dict(row_bwd(
            [k7_bwd_case("(h) qwen train_4k B=1 S=4096", 16, 4096, 4096, 64,
                         "f32"),
             k7_bwd_case(f"(i) trainer, a local step (K={LM_TRAIN_K}, B=4,"
                         f" 16 heads)", LM_TRAIN_K * 64, 64, 64, 64, "f32",
                         calls=20),
             k7_bwd_case(f"(i') trainer, phase A (K={LM_TRAIN_K}, nb=4, "
                         f"B=4, 16 heads)", LM_TRAIN_K * 256, 64, 64, 64,
                         "f32", calls=20),
             k7_bwd_case("(j) yi-9b B=1 S=2048 GQA-folded", 4, 8 * 2048,
                         2048, 128, "f32", period=2048, gqa=(1, 32, 4)),
             k7_bwd_case("(k) ragged", 16, 1000, 1000, 64, "f32"),
             k7_bwd_case("(l) qwen train_4k B=1 S=4096", 16, 4096, 4096, 64,
                         "bf16"),
             k7_bwd_case("(q) whisper encoder B=8 T=1500", 48, 1500, 1500,
                         64, "f32", period=1500, causal=False),
             k7_bwd_case("(r) whisper cross-attention B=8 S=448", 48, 448,
                         1500, 64, "f32", period=448, causal=False)])),
        # K8 at phase 10c's jamba prefills (di = 2 d_model = 8,192,
        # N=16) and the reduced preset at a length off the chunk
        row_k8([k8_case("(s1) jamba B=1 S=4096", 1, 4096, 8192, 16),
                k8_case("(s2) jamba B=2 S=1024", 2, 1024, 8192, 16),
                k8_case("(s3) jamba reduced B=2 S=200", 2, 200, 512, 8,
                        calls=100)]),
        # K8-bwd at the same shapes, and the trainer's vmap fold of two
        # clients (A a client) at the reduced preset
        row_k8_bwd([k8_bwd_case("(s1) jamba B=1 S=4096", 1, 4096, 8192, 16,
                                calls=5),
                    k8_bwd_case("(s2) jamba B=2 S=1024", 2, 1024, 8192, 16,
                                calls=5),
                    k8_bwd_case("(s3) jamba reduced B=2 S=200", 2, 200, 512,
                                8),
                    k8_bwd_case("(s3') the reduced trainer's fold of 2 "
                                "clients, B=2x4 S=64", 8, 64, 256, 8,
                                groups=2)]),
        # K9 and K10 at phase 10d's xlstm-350m prefills (H=4, dk=512,
        # dh=256), its mixers' B=1 S=4096, and the reduced preset
        row_xlstm(
            "mlstm_scan", "mlstm_scan.cu",
            "_mlstm_step, src/repro/models/xlstm.py:52-68, :105-106",
            [k9_case("(x1) xlstm B=1 S=4096", 1, 4096, 4, 512),
             k9_case("(x2) xlstm B=2 S=1024", 2, 1024, 4, 512),
             k9_case("(x3) xlstm B=2 S=256", 2, 256, 4, 512),
             k9_case("(x4) xlstm reduced B=2 S=100", 2, 100, 4, 128,
                     calls=100)]),
        row_xlstm(
            "slstm_scan", "slstm_scan.cu",
            "_slstm_step, src/repro/models/xlstm.py:141-160, :187-189",
            [k10_case("(y1) xlstm B=1 S=4096", 1, 4096, 4, 256),
             k10_case("(y2) xlstm B=2 S=1024", 2, 1024, 4, 256),
             k10_case("(y3) xlstm B=2 S=256", 2, 256, 4, 256),
             k10_case("(y4) xlstm reduced B=2 S=100", 2, 100, 4, 64,
                      calls=20)]),
        # K9-bwd and K10-bwd at phase 11d's gradients (H=4, dk=512,
        # dh=256), the reduced preset, and the reduced trainer's vmap fold
        # of two clients (d=128: dk=64, dh=32; the sLSTM's r a client)
        row_xlstm_bwd(
            "mlstm_scan_bwd", "mlstm_scan_bwd.cu",
            "_mlstm_step (src/repro/models/xlstm.py:52-68)",
            [k9_bwd_case("(x1) xlstm B=1 S=4096", 1, 4096, 4, 512),
             k9_bwd_case("(x2) xlstm B=2 S=1024", 2, 1024, 4, 512),
             k9_bwd_case("(x4) xlstm reduced B=2 S=100", 2, 100, 4, 128,
                         calls=20),
             k9_bwd_case("(x5) the reduced trainer's fold of 2 clients, "
                         "B=2x4 S=64", 8, 64, 4, 64, calls=20),
             k9_bwd_case("(x6) full width, a partial chunk, sub-chunk and "
                         "cluster walk, B=2 S=201", 2, 201, 4, 512)]),
        row_xlstm_bwd(
            "slstm_scan_bwd", "slstm_scan_bwd.cu",
            "_slstm_step (src/repro/models/xlstm.py:141-160)",
            [k10_bwd_case("(y1) xlstm B=1 S=4096", 1, 4096, 4, 256),
             k10_bwd_case("(y2) xlstm B=2 S=1024", 2, 1024, 4, 256),
             k10_bwd_case("(y4) xlstm reduced B=2 S=100", 2, 100, 4, 64,
                          calls=20),
             k10_bwd_case("(y5) the reduced trainer's fold of 2 clients, "
                          "B=2x4 S=64", 8, 64, 4, 32, groups=2,
                          calls=20),
             k10_bwd_case("(y6) the fold of 2 clients at full width, "
                          "B=2x1 S=1024", 2, 1024, 4, 256, groups=2)]),
    ]


def lstm_rows(specs) -> int:
    """Rows a device of the flat pack of the model of ``specs``."""
    import torch
    from repro_torch.core import pytree as pt
    from repro_torch.kernels import flatpack
    return flatpack.flat_spec(pt.tmap(lambda sp: torch.zeros(sp.shape),
                                      specs)).rows


#: The CPU path's solver mode for the logistic models of phases 4-7: K2's
#: plain version (``kernels/ref.py``), the mode ``auto`` takes on the
#: card for the paper config, ~6x the speed of the CPU's ``flat`` mode;
#: phases 8b-8d's CPU paths take it too.  The steps are the same SGD
#: steps, summed in another order.
CPU_SOLVER = "fused_epoch"


#: The CPU path's three runs of a cell: from w0 and from w0 nudged by
#: ``nudge`` times two numpy-seeded directions, as (seed, multiple of
#: ``nudge``).
NUDGES = ((7, 0.0), (7, 1.0), (8, 1.0))
#: Phases 8, 8c and 11b hand their CPU-path runs, which are independent,
#: to a pool of this many spawned processes, each on this share of the
#: host's cores (:func:`cpu_pool`); phases 8 and 8c's are all submitted
#: before phase 4, so that they run beside phases 4-8b.
CPU_WORKERS = 3
#: The workers' scheduling priority below this process's: the phases
#: they run beside keep the host first.
CPU_WORKER_NICE = 10


def nudged(torch, p0, seed: int, eps: float):
    """``p0`` plus ``eps`` times a direction drawn from ``seed``."""
    from repro_torch.core import pytree as pt
    rng = np.random.default_rng(seed)
    return pt.tmap(lambda x: x + torch.from_numpy(
        (eps * rng.normal(size=tuple(x.shape))).astype(np.float32)), p0)


def cpu_trajectory(torch, loss_fn, data_cpu, cfg, p, rounds: int):
    """``rounds`` rounds of ``cfg`` on the CPU path (batched engine;
    ``cfg`` says its solver mode) from ``p``: each round's params and
    selections."""
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt

    tr = FederatedTrainer(loss_fn, data_cpu,
                          dataclasses.replace(cfg, engine="batched"),
                          device="cpu")
    st = tr.init(p)
    traj = []
    for _ in range(rounds):
        st = tr.round(st)
        traj.append((pt.tmap(torch.clone, st.params), tr.last_selection))
    return traj


def trajectory_spread(torch, runs):
    """Per round of :data:`NUDGES`' runs: the params and selections of
    the run from w0, the larger move of the two nudged runs (the spread
    float32 rounding can cause) and max |param|."""
    from repro_torch.core import pytree as pt

    base = runs[0]
    spread = [max(max_err(torch, base[r][0], o[r][0]) for o in runs[1:])
              for r in range(len(base))]
    scale = [max(float(x.abs().max()) for x in pt.leaves(b[0]))
             for b in base]
    return base, spread, scale


def cpu_trajectories(torch, loss_fn, data_cpu, cfg, p0, rounds: int,
                     nudge: float = 1e-7):
    """:func:`trajectory_spread` of :data:`NUDGES`' runs of ``cfg`` from
    ``p0``, one after another in this process."""
    return trajectory_spread(torch, [
        cpu_trajectory(torch, loss_fn, data_cpu, cfg,
                       nudged(torch, p0, seed, k * nudge), rounds)
        for seed, k in NUDGES])


def _cpu_worker(threads: int, src: str) -> None:
    import torch
    if src not in sys.path:
        sys.path.insert(0, src)
    torch.set_num_threads(threads)
    os.nice(CPU_WORKER_NICE)


def cpu_pool():
    """A pool of :data:`CPU_WORKERS` spawned processes for the CPU
    path's runs, each with ``torch.set_num_threads`` at its share of the
    cores this process may use, at :data:`CPU_WORKER_NICE`; returns it
    and that thread count.  The workers make their data anew from the
    seeds (:func:`cpu_data`)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    threads = max(1, len(os.sched_getaffinity(0)) // CPU_WORKERS)
    pool = ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker, initargs=(threads, str(ROOT / "src")))
    return pool, threads


_CPU_DATA = {}


def cpu_data(recipe):
    """The CPU path's dataset of ``recipe`` = (kind, devices, sample
    cap), made from its seeds once a process: the paper's synthetic(1,1)
    (seed 0, B=10), or phase 8's Sent140-like (seed 0, its loss over
    LOSS_DEVICES) or Shakespeare-like (seed 0, at the cap)."""
    if recipe not in _CPU_DATA:
        from repro_torch.data import make_synthetic
        from repro_torch.data.batching import FederatedData
        from repro_torch.data.leaf_like import (generate_sent140_like,
                                                generate_shakespeare_like)
        kind, n, cap = recipe
        if kind == "synthetic":
            data = make_synthetic(1, 1, num_devices=n, seed=0,
                                  batch_size=10, device="cpu")
        elif kind == "sent140":
            data = FederatedData(generate_sent140_like(n, seed=0), 10,
                                 name="sent140_like",
                                 eval_sample=LOSS_DEVICES, device="cpu")
        else:
            data = FederatedData(
                generate_shakespeare_like(n, seed=0, sample_cap=cap), 10,
                name="shakespeare_like", device="cpu")
        _CPU_DATA[recipe] = data
    return _CPU_DATA[recipe]


def _pooled_trajectory(recipe, loss_fn, cfg, p0, seed, eps, rounds):
    import torch
    return cpu_trajectory(torch, loss_fn, cpu_data(recipe), cfg,
                          nudged(torch, p0, seed, eps), rounds)


def pooled_trajectories(pool, recipe, loss_fn, cfg, p0, rounds: int,
                        nudge: float = 1e-7):
    """:data:`NUDGES`' runs of :func:`cpu_trajectories`, submitted to
    ``pool`` on ``recipe``'s data: their futures, in order."""
    return [pool.submit(_pooled_trajectory, recipe, loss_fn, cfg, p0, seed,
                        k * nudge, rounds) for seed, k in NUDGES]


def results(futures):
    """The results of ``futures`` and the seconds spent waiting."""
    t0 = time.perf_counter()
    return [f.result() for f in futures], time.perf_counter() - t0


def cpu_sensitivity(torch, data_cpu, cfg, rounds: int = 1):
    """:func:`cpu_trajectories` of logistic regression from zeros on
    :data:`CPU_SOLVER`, after its last round: the spread and max
    |param|."""
    from repro_torch.models.param import init_params
    from repro_torch.models.small import logreg_loss, logreg_specs

    d = data_cpu.device_batches(0)["x"].shape[-1]
    p0 = init_params(logreg_specs(d, 10), torch.Generator(), device="cpu")
    _, spread, scale = cpu_trajectories(
        torch, logreg_loss, data_cpu,
        dataclasses.replace(cfg, local_solver=CPU_SOLVER), p0, rounds)
    return spread[-1], scale[-1]


def run_pair(torch, syn_gpu, syn_cpu, cfg, rounds: int, label: str,
             tol: float = TRAJECTORY_TOL):
    """``rounds`` rounds of ``cfg`` on the card and on the CPU path (on
    :data:`CPU_SOLVER` unless ``cfg`` names an explicit mode), held
    together round by round; returns the card's trainer, its final state
    and the median ms/round."""
    from repro_torch.core import FederatedTrainer
    from repro_torch.models.param import init_params
    from repro_torch.models.small import logreg_loss, logreg_specs

    d = syn_cpu.device_batches(0)["x"].shape[-1]
    gen = torch.Generator().manual_seed(0)
    gpu = FederatedTrainer(logreg_loss, syn_gpu, cfg)
    solver = CPU_SOLVER if cfg.local_solver == "auto" else cfg.local_solver
    cpu = FederatedTrainer(logreg_loss, syn_cpu,
                           dataclasses.replace(cfg, engine="batched",
                                               local_solver=solver),
                           device="cpu")
    sg = gpu.init(init_params(logreg_specs(d, 10), gen))
    sc = cpu.init(init_params(logreg_specs(d, 10), gen, device="cpu"))
    ms, losses, errs, eff_k = [], [], [], []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sg = gpu.round(sg)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        sc = cpu.round(sc)
        for a, b in zip(gpu.last_selection, cpu.last_selection):
            check(np.array_equal(a, b), f"{label}: selections differ")
        gm, cm = gpu.last_masks, cpu.last_masks
        check((gm is None) == (cm is None) and (gm is None or all(
            np.array_equal(a, b) for a, b in zip(gm, cm))),
              f"{label}: scenario masks differ")
        if gm is not None:
            eff_k.append(gpu.last_env[1])
        errs.append(max_err(torch, {k: v.cpu() for k, v in
                                    sg.params.items()}, sc.params))
        check(errs[-1] <= tol, f"{label}: params differ by {errs[-1]} "
                               f"> {tol}")
        lg = gpu.global_loss(sg.params)
        check(np.isfinite(lg), f"{label}: loss not finite")
        losses.append((lg, cpu.global_loss(sc.params)))
    print(f"  {label}: ms/round {[round(m, 2) for m in ms]} "
          f"(median {statistics.median(ms):.2f})")
    print(f"    loss card {[round(a, 6) for a, _ in losses]}")
    print(f"    loss cpu  {[round(b, 6) for _, b in losses]}")
    print(f"    max |params card - cpu| per round "
          f"{[f'{e:.2e}' for e in errs]} (tol {tol:.3g})")
    if eff_k:
        print(f"    selections and masks equal every round; effective K "
              f"per round {eff_k}")
    return gpu, sg, statistics.median(ms)


#: Phase 8: the paper's non-convex tasks (Fig. 1) at full model width
#: (the specs' defaults), with Fig. 1's settings
#: (benchmarks/fig1_convergence.py:15,60-67): lr and E per task, mu per
#: algorithm -- but Sent140's E cut from 2 to 1 for the script's time.
#: Sent140-like at Table I's N=772, the global loss over a seeded sample
#: of LOSS_DEVICES of its devices; Shakespeare-like at N=143 with each
#: device's samples capped at the generator's default 512 for the
#: card-only round and at SHAKES_CPU_CAP where the CPU path runs too.
SENT140 = dict(num_devices=772, devices_per_round=10, local_epochs=1,
               local_batch_size=10, learning_rate=0.1, seed=0)
SHAKESPEARE = dict(num_devices=143, devices_per_round=10, local_epochs=1,
                   local_batch_size=10, learning_rate=0.3, seed=0)
FIG1_MU = {"feddane": 0.001, "fedprox": 1.0, "fedavg": 0.0}
LSTM_ROUNDS = 2
#: The Shakespeare-like CPU path takes ~37 s a round at sample_cap 64
#: on the card's host (~38 GFLOP a local step, 8 steps and two gradient
#: passes of 8 batches), three times over for the spread: its flat cell
#: is held to it for this many of its rounds, at this cap (every device
#: then has 32 samples, 4 batches).
SHAKES_CPU_ROUNDS = 1
SHAKES_CPU_CAP = 32
LOSS_DEVICES = 50
#: The card's and the CPU path's global loss at the same round, relative.
LOSS_REL = 1e-5


def lstm_cell(torch, label, loss_fn, data, cpu_runs, cfg, p0,
              rounds: int, counts):
    """``rounds`` rounds of ``cfg`` on the card from ``p0`` (CUDA events
    around each), the first rounds held against the CPU path's runs
    (``cpu_runs``: the futures of :func:`pooled_trajectories`, or None):
    the same selections, params within SPREAD_FACTOR x the spread a 1e-7
    nudge of ``p0`` causes there (TRAJECTORY_TOL where it causes none),
    that limit under MAX_REL_LIMIT of the params' scale.  Returns the
    card's trainer and state, the ms of its rounds, its launches and the
    CPU path's compared rounds, ``(params, selections, limit)`` each."""
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt

    base, spread, scale = [], [], []
    if cpu_runs:
        runs, waited = results(cpu_runs)
        base, spread, scale = trajectory_spread(torch, runs)
        print(f"  {label}: CPU path, {len(base)} round(s) x 3 runs in the "
              f"pool (waited {waited:.1f} s); a 1e-7 nudge of w0 moves "
              f"params by {[f'{x:.2e}' for x in spread]}; max |param| "
              f"{[f'{x:.3g}' for x in scale]}")
    cpu_rounds = len(base)
    tr = FederatedTrainer(loss_fn, data, cfg)
    st = tr.init(p0)
    before = dict(counts)
    ms, errs, tols = [], [], []
    for r in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st = tr.round(st)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        if r >= cpu_rounds:
            continue
        params_cpu, sel = base[r]
        for a, b in zip(tr.last_selection, sel):
            check(np.array_equal(a, b), f"{label}: round {r} selections "
                                        f"differ from the CPU path's")
        tol = SPREAD_FACTOR * spread[r] if spread[r] > 0 else TRAJECTORY_TOL
        check(tol <= MAX_REL_LIMIT * scale[r],
              f"{label}: limit {tol} exceeds {MAX_REL_LIMIT} x {scale[r]}")
        errs.append(max_err(torch, pt.tmap(lambda x: x.cpu(), st.params),
                            params_cpu))
        tols.append(tol)
        check(errs[-1] <= tol, f"{label}: round {r} params differ from the "
                               f"CPU path by {errs[-1]} > {tol}")
    launches = _delta(before, counts)
    check(all(bool(torch.isfinite(x).all()) for x in pt.leaves(st.params)),
          f"{label}: params not finite")
    check(not launches.get("local_epoch") and
          not launches.get("linear_logistic_step"),
          f"{label}: a logistic-regression kernel launched: {launches}")
    print(f"  {label}: ms/round {[round(m, 2) for m in ms]} (CUDA events)"
          f"; launches {launches}")
    if errs:
        print(f"    selections equal the CPU path's; max |params card - "
              f"cpu| per round {[f'{e:.2e}' for e in errs]} (limits "
              f"{[f'{t:.2e}' for t in tols]})")
    return tr, st, ms, launches, [(b[0], b[1], t)
                                  for b, t in zip(base, tols)]


def step_breakdown(torch, loss_fn, data, trainer, st, label: str, k1):
    """One local step of the trainer's last solve selection at ``st``,
    in parts: the host's ``vmap(grad)`` over the K devices' first batch
    (CUDA events, median of 3; the card's idle share in one more call
    under the profiler, card activity only) against K1 on the model's
    pack (``k1``: phase 3's case, call and device ms)."""
    from torch.func import grad, vmap

    from repro_torch.core import pytree as pt
    from repro_torch.data.batching import stack_device_batches

    S = trainer.last_selection[1]
    batches, _ = stack_device_batches(data, S)
    batch = pt.tmap(lambda x: x[:, 0].contiguous(), batches)
    w = pt.tmap(lambda x: x.expand((len(S),) + x.shape).contiguous(),
                st.params)
    fn = vmap(grad(loss_fn))
    ms = cuda_ms(torch, lambda: fn(w, batch), 1, repeats=3)
    device_share(torch, lambda: fn(w, batch),
                 f"{label}: one local step's vmap(grad)", host_ops=False)
    print(f"    a local step: vmap(grad) {ms:.2f} ms (CUDA events); K1 "
          f"{k1['ms']:.4f} ms a call, {k1['device_ms']:.5f} ms on the "
          f"card: {k1['ms'] / (ms + k1['ms']):.2e} of the step")


def lstm_cpu_jobs(pool):
    """Phase 8's CPU-path runs, submitted to ``pool``: Sent140-like's
    three cells (LSTM_ROUNDS rounds) and Shakespeare-like's flat cell
    (SHAKES_CPU_ROUNDS at SHAKES_CPU_CAP), :data:`NUDGES`' runs each."""
    import torch
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.data.leaf_like import SENT_VOCAB, SHAKES_VOCAB
    from repro_torch.models.param import init_params
    from repro_torch.models.small import (charlstm_loss, charlstm_specs,
                                          sentlstm_loss, sentlstm_specs)

    jobs = {}
    p0 = init_params(sentlstm_specs(SENT_VOCAB),
                     torch.Generator().manual_seed(0), device="cpu")
    for algo, mu in FIG1_MU.items():
        cfg = FederatedConfig(algorithm=algo, mu=mu, **SENT140)
        jobs[f"sent140/{algo}"] = pooled_trajectories(
            pool, ("sent140", SENT140["num_devices"], None), sentlstm_loss,
            cfg, p0, LSTM_ROUNDS)
    p0 = init_params(charlstm_specs(SHAKES_VOCAB),
                     torch.Generator().manual_seed(0), device="cpu")
    cfg = FederatedConfig(algorithm="feddane", mu=FIG1_MU["feddane"],
                          local_solver="flat", **SHAKESPEARE)
    jobs["shakespeare/flat"] = pooled_trajectories(
        pool, ("shakespeare", SHAKESPEARE["num_devices"], SHAKES_CPU_CAP),
        charlstm_loss, cfg, p0, SHAKES_CPU_ROUNDS)
    return jobs


def lstm_phase(torch, counts, k1_cases, cpu_jobs):
    """Phase 8: Sent140-like and Shakespeare-like through the LSTMs on
    the python driver, on the card against the CPU path; the rounds run
    K1 (``flat``, what ``auto`` resolves to) or K4 (``per_leaf``) once a
    local step.  vmap's per-sample fallback is switched off throughout,
    so an op without a batching rule fails the phase.  Returns the cells'
    ms/round and the Sent140 feddane cell's CPU-path rounds for phase 8b;
    ``k1_cases``: phase 3's K1 case on each LSTM's pack (rows a device
    -> case), for the breakdown; ``cpu_jobs``: :func:`lstm_cpu_jobs`."""
    import torch._C._functorch as functorch
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.data.batching import FederatedData
    from repro_torch.data.leaf_like import (SENT_VOCAB, SHAKES_VOCAB,
                                            generate_sent140_like,
                                            generate_shakespeare_like)
    from repro_torch.models.param import init_params, param_count
    from repro_torch.models.small import (charlstm_loss, charlstm_specs,
                                          sentlstm_loss, sentlstm_specs)

    out = {}
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        t0 = time.perf_counter()
        devs = generate_sent140_like(SENT140["num_devices"], seed=0)
        sent = FederatedData(devs, 10, name="sent140_like",
                             eval_sample=LOSS_DEVICES)
        sent_cpu = FederatedData(devs, 10, name="sent140_like",
                                 eval_sample=LOSS_DEVICES, device="cpu")
        specs = sentlstm_specs(SENT_VOCAB)
        p0 = init_params(specs, torch.Generator().manual_seed(0),
                         device="cpu")
        rows = lstm_rows(specs)
        print(f"  Sent140-like: N={sent.num_devices}, "
              f"{sent.stats()['samples']} samples, sentlstm(400, 25, 100) "
              f"{param_count(specs):,} params ({rows} pack rows a device), "
              f"K=10 B=10 lr={SENT140['learning_rate']} "
              f"E={SENT140['local_epochs']} (cut from Fig. 1's 2 for the "
              f"script's time); data in "
              f"{time.perf_counter() - t0:.1f} s")
        for algo, mu in FIG1_MU.items():
            cfg = FederatedConfig(algorithm=algo, mu=mu, **SENT140)
            tr, st, ms, grew, cpu_rounds = lstm_cell(
                torch, f"sent140 {algo} auto", sentlstm_loss, sent,
                cpu_jobs[f"sent140/{algo}"], cfg, p0, LSTM_ROUNDS, counts)
            p_cpu = cpu_rounds[-1][0]
            check(grew.get("dane_update_flat", 0) > 0 and
                  not grew.get("dane_update_2d"),
                  f"sent140 {algo}: auto did not run K1 alone: {grew}")
            out[f"sent140/{algo}"] = statistics.median(ms)
            per_round = grew["dane_update_flat"] / LSTM_ROUNDS
            k1_ms = per_round * k1_cases[rows]["device_ms"]
            share = k1_ms / out[f"sent140/{algo}"]
            print(f"    K1: {per_round:g} launches a round (one a local "
                  f"step), {k1_ms:.3f} ms of "
                  f"device time, {share:.2e} of the round")
            if algo == "feddane":
                lg = tr.global_loss(st.params)
                lc = FederatedTrainer(sentlstm_loss, sent_cpu, cfg,
                                      device="cpu").global_loss(p_cpu)
                check(np.isfinite(lg) and abs(lg - lc) <= LOSS_REL * abs(lc),
                      f"sent140 feddane: global loss {lg} on the card, "
                      f"{lc} on the CPU path")
                print(f"    global loss over {LOSS_DEVICES} devices after "
                      f"{LSTM_ROUNDS} rounds: card {lg:.7f}, CPU path "
                      f"{lc:.7f}")
                step_breakdown(torch, sentlstm_loss, sent, tr, st,
                               "sent140 feddane", k1_cases[rows])
                # phase 8b replays these rounds' selections on the
                # scanned driver, held to these limits; phase 8c holds
                # the buffered driver to the card's final params
                handoff = dict(devs=devs, p0=p0, cfg=cfg, ms=ms,
                               rounds=cpu_rounds,
                               card=pt.tmap(lambda x: x.cpu(), st.params))
            del tr, st
        del sent, sent_cpu, devs

        t0 = time.perf_counter()
        specs = charlstm_specs(SHAKES_VOCAB)
        rows = lstm_rows(specs)
        p0 = init_params(specs, torch.Generator().manual_seed(0),
                         device="cpu")
        devs = generate_shakespeare_like(SHAKESPEARE["num_devices"], seed=0,
                                         sample_cap=SHAKES_CPU_CAP)
        shak = FederatedData(devs, 10, name="shakespeare_like")
        n_leaves = len(pt.leaves(specs))
        print(f"  Shakespeare-like: N={shak.num_devices}, sample_cap "
              f"{SHAKES_CPU_CAP} (cut from 512 for the CPU path's time), "
              f"{shak.stats()['samples']} samples, charlstm(80, 8, 256) "
              f"{param_count(specs):,} params in {n_leaves} leaves "
              f"({rows} pack rows a device), K=10 B=10 "
              f"lr={SHAKESPEARE['learning_rate']} "
              f"E={SHAKESPEARE['local_epochs']}; data in "
              f"{time.perf_counter() - t0:.1f} s")
        finals, grown = {}, {}
        for mode in ("flat", "per_leaf"):
            cfg = FederatedConfig(algorithm="feddane",
                                  mu=FIG1_MU["feddane"], local_solver=mode,
                                  **SHAKESPEARE)
            tr, st, ms, grown[mode], _ = lstm_cell(
                torch, f"shakespeare feddane {mode}", charlstm_loss, shak,
                cpu_jobs.get(f"shakespeare/{mode}"), cfg, p0, LSTM_ROUNDS,
                counts)
            out[f"shakespeare/{mode}"] = statistics.median(ms)
            finals[mode] = pt.tmap(torch.clone, st.params)
            if mode == "flat":
                step_breakdown(torch, charlstm_loss, shak, tr, st,
                               "shakespeare feddane flat", k1_cases[rows])
            del tr, st
        for a, b in zip(pt.leaves(finals["flat"]),
                        pt.leaves(finals["per_leaf"])):
            check(torch.equal(a, b), "shakespeare: flat and per_leaf "
                                     "differ on the card")
        steps = grown["flat"]["dane_update_flat"]
        check(grown["per_leaf"].get("dane_update_2d") == steps and
              not grown["per_leaf"].get("dane_update_flat") and
              not grown["flat"].get("dane_update_2d"),
              f"shakespeare: per_leaf launched K4 "
              f"{grown['per_leaf'].get('dane_update_2d')} times in the "
              f"{steps} steps flat launched K1")
        print(f"  shakespeare: flat == per_leaf bitwise on the card; "
              f"{steps} K1 launches in flat, as many K4 launches in "
              f"per_leaf (one a step over all {n_leaves} leaves); K1 "
              f"{k1_cases[rows]['device_ms'] * 1e3:.2f} us a launch on the "
              f"card, {steps / LSTM_ROUNDS * k1_cases[rows]['device_ms']:.3f}"
              f" ms a round "
              f"of {out['shakespeare/flat']:.1f}")
        del shak, devs, finals

        # one card-only round at the generator's default sample_cap
        t0 = time.perf_counter()
        devs = generate_shakespeare_like(SHAKESPEARE["num_devices"], seed=0)
        full = FederatedData(devs, 10, name="shakespeare_like")
        print(f"  Shakespeare-like at sample_cap 512: "
              f"{full.stats()['samples']} samples; data in "
              f"{time.perf_counter() - t0:.1f} s")
        cfg = FederatedConfig(algorithm="feddane", mu=FIG1_MU["feddane"],
                              **SHAKESPEARE)
        tr = FederatedTrainer(charlstm_loss, full, cfg)
        st = tr.init(p0)
        before = dict(counts)
        torch.cuda.synchronize()
        start = time.perf_counter()
        st = tr.round(st)
        torch.cuda.synchronize()
        out["shakespeare/auto cap 512"] = (time.perf_counter() - start) * 1e3
        grew = _delta(before, counts)
        check(grew.get("dane_update_flat", 0) > 0 and all(
            bool(torch.isfinite(x).all()) for x in pt.leaves(st.params)),
            f"shakespeare cap 512: {grew}, or params not finite")
        print(f"  shakespeare feddane auto, sample_cap 512, one round: "
              f"{out['shakespeare/auto cap 512']:.1f} ms (host clock); "
              f"launches {grew}; K1 "
              f"{grew['dane_update_flat'] * k1_cases[rows]['device_ms']:.3f}"
              f" ms of "
              f"device time")
        del tr, st, full, devs
    finally:
        functorch._set_vmap_fallback_enabled(was)
    torch.cuda.empty_cache()
    return out, handoff


#: Phase 8b: the scanned driver.  The paper config's cells run one chunk
#: of SCAN_ROUNDS; the sampled cell two chunks of SCAN_CHUNK, twice; the
#: hostile int8 cell SCAN_HOSTILE_ROUNDS; Sent140 phase 8's LSTM_ROUNDS.
SCAN_ROUNDS = 5
SCAN_SAMPLED_ROUNDS = 20
SCAN_CHUNK = 10
SCAN_HOSTILE_ROUNDS = 3


class ScanRecorder:
    """Records, inside the scanned driver's round -- so inside its CUDA
    graph on the card -- each round's selections, solve masks, work
    fractions and phase-A availability into tensors indexed by the
    round (the driver's counter ``ctr[1]``), by wrapping the sampler
    and the staged scenario interpreter the round calls.  Use as a
    context; ``bind(trainer)`` before its ``run``."""

    def __init__(self, torch, rounds: int, k: int, device, phases: int):
        self.torch, self.phases, self.trainer = torch, phases, None
        self.sel = torch.full((rounds, 2, k), -1, dtype=torch.long,
                              device=device)
        self.active, self.work, self.avail = (
            torch.full((rounds, k), -1.0, device=device) for _ in range(3))
        self._calls = 0

    def bind(self, trainer):
        self.trainer = trainer
        return self

    def _put(self, buf, x):
        buf.index_copy_(0, self.trainer._scanned._ctr[1:2], x.unsqueeze(0))

    def __enter__(self):
        from repro_torch.core import engine, server
        self._saved = (server.sample_devices_onchip,
                       engine.realize_env_staged,
                       engine.availability_mask_staged)
        sample, realize, avail = self._saved

        def spy_sample(*a, **k):
            sel = sample(*a, **k)
            phase = self._calls % self.phases
            self._calls += 1
            self._put(self.sel[:, phase], sel)
            return sel

        def spy_env(*a):
            env = realize(*a)
            self._put(self.active, env.active)
            self._put(self.work, env.work)
            return env

        def spy_avail(*a):
            m = avail(*a)
            self._put(self.avail, m)
            return m

        server.sample_devices_onchip = spy_sample
        engine.realize_env_staged = spy_env
        engine.availability_mask_staged = spy_avail
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine, server
        (server.sample_devices_onchip, engine.realize_env_staged,
         engine.availability_mask_staged) = self._saved

    def numpy(self):
        return {k: getattr(self, k).cpu().numpy()
                for k in ("sel", "active", "work", "avail")}


def _scan_cfg(**kw):
    from repro_torch.configs.base import FederatedConfig
    return FederatedConfig(mu=0.001, round_driver="scan", **dict(PAPER, **kw))


def _logreg_p0(torch, device=None):
    from repro_torch.models.param import init_params
    from repro_torch.models.small import logreg_specs
    return init_params(logreg_specs(60, 10), torch.Generator().manual_seed(0),
                       device=device)


def _timed_run(torch, trainer, rounds: int, **kw):
    """``trainer.run`` between CUDA events: the history, params and ms a
    round."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    hist, params = trainer.run(**kw, num_rounds=rounds)
    end.record()
    end.synchronize()
    return hist, params, start.elapsed_time(end) / rounds


def _programs(trainer) -> str:
    drv = trainer._scanned
    return ", ".join(f"{k}: {drv.capture_s[k]:.2f} s, launches a replay "
                     f"{p.launches}" for k, p in drv._programs.items())


def scan_phase(torch, counts, syn, syn_cpu, int8_tol: float, sent140):
    """Phase 8b: the scanned driver on the card, each round a replay of
    its captured CUDA graph.  Returns ms/round of the timed cells."""
    import torch._C._functorch as functorch
    from repro_torch.core import FederatedTrainer, engine, server
    from repro_torch.core import pytree as pt
    from repro_torch.core.scenarios import env_channels, scenario_spec
    from repro_torch.data.batching import FederatedData
    from repro_torch.models.small import logreg_loss, sentlstm_loss

    out = {}
    # the CPU scanned driver runs the mode the card's `auto` takes, K2,
    # on its plain version: 6x the CPU's flat mode, for the script's time
    on_cpu = dict(engine="batched", local_solver="fused_epoch")
    # (a) the paper config on injected selections, drawn by the port's
    # on-card sampler from a CPU generator seeded like the driver's
    gen = torch.Generator().manual_seed(PAPER["seed"])
    sel = np.stack([np.stack([server.sample_devices_onchip(
        gen, 30, 10).numpy() for _ in range(2)]) for _ in range(SCAN_ROUNDS)])
    for algo in ("feddane", "fedprox", "fedavg"):
        cfg = _scan_cfg(algorithm=algo, chunk_rounds=SCAN_ROUNDS)
        label = f"scan {algo} auto"
        hc, pc = FederatedTrainer(
            logreg_loss, syn_cpu, dataclasses.replace(cfg, **on_cpu),
            device="cpu").run(_logreg_p0(torch, "cpu"), SCAN_ROUNDS,
                              selections=sel)
        tr = FederatedTrainer(logreg_loss, syn, cfg)
        check(tr._resolve_driver() == "scan", f"{label}: not on scan")
        before = dict(counts)
        hg, pg, ms = _timed_run(torch, tr, SCAN_ROUNDS,
                                params=_logreg_p0(torch),
                                selections=sel)
        grew = _delta(before, counts)
        progs = tr._scanned._programs
        check(progs["injected"].launches == {"local_epoch": 1},
              f"{label}: a replay launches {progs['injected'].launches}, "
              f"not K2 once")
        check(grew.get("local_epoch") == SCAN_ROUNDS + 1,
              f"{label}: {grew} (K2 once a replay plus the warm-up)")
        err = max_err(torch, pt.tmap(lambda x: x.cpu(), pg), pc)
        # the loss within TRAJECTORY_TOL of its own scale: feddane's loss
        # runs to ~100 at mu=0.001, where a float32 ulp is 7.6e-6
        dloss = float(max(abs(a - b) / max(1.0, abs(b))
                          for a, b in zip(hg["loss"], hc["loss"])))
        check(err <= TRAJECTORY_TOL and dloss <= TRAJECTORY_TOL,
              f"{label}: params {err}, loss {dloss} (relative above 1) "
              f"from the CPU scanned driver > {TRAJECTORY_TOL}")
        check(all(hg[k] == hc[k] for k in hc if k != "loss"),
              f"{label}: history differs from the CPU scanned driver's")
        print(f"  {label}: {SCAN_ROUNDS} rounds, one chunk, "
              f"{ms:.2f} ms/round with the captures (CUDA events); "
              f"captured {_programs(tr)}")
        print(f"    against the CPU scanned driver: max |params| "
              f"{err:.2e}, max |loss| / max(1, |loss|) {dloss:.2e} (tol "
              f"{TRAJECTORY_TOL:g}); launches {grew}")

    # (b) sampled on the card: two runs of two chunks, bitwise equal
    cfg = _scan_cfg(algorithm="feddane", chunk_rounds=SCAN_CHUNK)
    tr = FederatedTrainer(logreg_loss, syn, cfg)
    # one recorder for both runs: the graphs captured in the first write
    # into its tensors at every replay, so it lives as long as they do
    rec = ScanRecorder(torch, SCAN_SAMPLED_ROUNDS, 10, syn.device,
                       2).bind(tr)
    recs, runs = [], []
    for r in range(2):
        with rec:
            t0 = time.perf_counter()
            h, p, ms = _timed_run(torch, tr, SCAN_SAMPLED_ROUNDS,
                                  params=_logreg_p0(torch))
            wall = time.perf_counter() - t0
        recs.append(rec.numpy()["sel"])
        runs.append((h, p, ms, wall))
    (h1, p1, _, wall1), (h2, p2, ms2, _) = runs
    check(h1 == h2 and all(torch.equal(a, b) for a, b in
                           zip(pt.leaves(p1), pt.leaves(p2))),
          "scan sampled: two runs of one seed differ")
    check(np.array_equal(recs[0], recs[1]) and (recs[0] >= 0).all(),
          "scan sampled: the runs' selections differ")
    distinct = len({recs[0][t].tobytes()
                    for t in range(SCAN_SAMPLED_ROUNDS)})
    check(distinct > 1, "scan sampled: every round selected alike")
    check(all(np.isfinite(h1["loss"])), "scan sampled: loss not finite")
    out["scan feddane sampled"] = ms2
    print(f"  scan feddane sampled, {SCAN_SAMPLED_ROUNDS} rounds in chunks "
          f"of {SCAN_CHUNK}: run 1 {wall1:.2f} s (host clock; captured "
          f"{_programs(tr)}); run 2 {ms2:.3f} ms/round (CUDA events); "
          f"bitwise equal; {distinct} distinct selections in "
          f"{SCAN_SAMPLED_ROUNDS} rounds")
    py = FederatedTrainer(logreg_loss, syn, dataclasses.replace(
        cfg, round_driver="python"))
    py.run(_logreg_p0(torch), 2)                       # warm-up
    _, _, py_ms = _timed_run(torch, py, SCAN_SAMPLED_ROUNDS,
                             params=_logreg_p0(torch))
    out["python feddane sampled"] = py_ms
    print(f"  the python driver, same config and card: {py_ms:.3f} ms/round"
          f" (CUDA events, {SCAN_SAMPLED_ROUNDS} rounds)")
    device_share(torch, lambda: tr.run(_logreg_p0(torch), SCAN_CHUNK),
                 f"scan feddane sampled, one chunk of {SCAN_CHUNK} rounds")
    device_share(torch, lambda: py.run(_logreg_p0(torch), SCAN_CHUNK),
                 f"python feddane, {SCAN_CHUNK} rounds")

    # (c) hostile + int8 on injected selections and env uniforms: the
    # card against the CPU scanned driver, masks bit for bit
    rounds = SCAN_HOSTILE_ROUNDS
    cfg = _scan_cfg(algorithm="feddane", scenario="hostile", codec="int8",
                    chunk_rounds=rounds)
    rng = np.random.default_rng(0)
    table = {c: rng.random((rounds, 30)).astype(np.float32)
             for c in env_channels(scenario_spec("hostile"))}
    on = {d.type: {c: torch.from_numpy(v).to(d) for c, v in table.items()}
          for d in (syn_cpu.device, syn.device)}
    saved = engine.scan_env_uniforms
    engine.scan_env_uniforms = (
        lambda gen, channels, n, t: {c: on[t.device.type][c].index_select(
            0, t)[0] for c in channels})
    got = {}
    try:
        for name, data in (("cpu", syn_cpu), ("card", syn)):
            tr = FederatedTrainer(logreg_loss, data, dataclasses.replace(
                cfg, **on_cpu) if name == "cpu" else cfg,
                device=data.device)
            before = dict(counts)
            with ScanRecorder(torch, rounds, 10, data.device,
                              2).bind(tr) as rec:
                h, p = tr.run(_logreg_p0(torch, data.device), rounds,
                              selections=sel[:rounds])
            got[name] = (h, pt.tmap(lambda x: x.cpu(), p), rec.numpy(),
                         _delta(before, counts), tr, rec)
    finally:
        engine.scan_env_uniforms = saved
    (hc, pc, rc, *_), (hg, pg, rg, grew, tr, _) = got["cpu"], got["card"]
    for k in ("active", "work", "avail"):
        check(np.array_equal(rc[k].view(np.int32), rg[k].view(np.int32))
              and (rc[k] >= 0).all(),
              f"scan hostile int8: {k} differs from the CPU scanned driver")
    check(hg["effective_k"] == hc["effective_k"],
          f"scan hostile int8: effective K {hg['effective_k']} != "
          f"{hc['effective_k']}")
    err = max_err(torch, pg, pc)
    check(err <= int8_tol, f"scan hostile int8: params {err} > {int8_tol}")
    check(tr._scanned._programs["injected"].launches.get(
        "codec_aggregate") == 1 and grew.get("codec_aggregate") == rounds + 1,
        f"scan hostile int8: K5 launches {grew} (once a replay plus the "
        f"warm-up)")
    print(f"  scan feddane hostile int8, {rounds} rounds: masks, work and "
          f"phase-A availability bitwise equal to the CPU scanned driver; "
          f"effective K {hg['effective_k']}; max |params| {err:.2e} (tol "
          f"{int8_tol:.2e}); captured {_programs(tr)}; launches {grew}")

    # (d) Sent140-like feddane: phase 8's CPU-path selections replayed,
    # held to phase 8's own limits
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        data = FederatedData(sent140["devs"], 10, name="sent140_like",
                             eval_sample=LOSS_DEVICES)
        cfg = dataclasses.replace(sent140["cfg"], round_driver="scan",
                                  chunk_rounds=LSTM_ROUNDS)
        rounds = sent140["rounds"]
        ssel = np.stack([np.stack(s) for _, s, _ in rounds])
        tr = FederatedTrainer(sentlstm_loss, data, cfg)
        before = dict(counts)
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        h1, p1, _ = _timed_run(torch, tr, len(rounds), params=sent140["p0"],
                               selections=ssel)
        wall1 = time.perf_counter() - t0
        reserved = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
        grew = _delta(before, counts)
        params_cpu, _, limit = rounds[-1]
        err = max_err(torch, pt.tmap(lambda x: x.cpu(), p1), params_cpu)
        check(err <= limit, f"scan sent140 feddane: params differ from "
                            f"phase 8's CPU path by {err} > {limit}")
        check(all(np.isfinite(h1["loss"])), "scan sent140: loss not finite")
        k1 = tr._scanned._programs["injected"].launches.get(
            "dane_update_flat", 0)
        check(k1 > 0, "scan sent140: a replay launches no K1")
        # timed apart from the captures (the LSTM's embedding gradient
        # sums with atomics, so this run need not repeat run 1's bits)
        h2, _, ms = _timed_run(torch, tr, len(rounds), params=sent140["p0"],
                               selections=ssel)
        check(all(np.isfinite(h2["loss"])), "scan sent140: loss not finite")
        out["scan sent140 feddane"] = ms
        print(f"  scan sent140 feddane, {len(rounds)} rounds: run 1 "
              f"{wall1:.2f} s (host clock), captured {_programs(tr)}; run "
              f"2 {ms:.2f} ms/round (CUDA events); phase 8's python driver "
              f"{[round(m, 2) for m in sent140['ms']]} ms/round")
        print(f"    max |params card - phase 8's CPU path| {err:.2e} (limit "
              f"{limit:.2e}); loss {[round(x, 6) for x in h1['loss']]}; "
              f"launches in run 1 {grew}; the card's reserved memory grew "
              f"{reserved:.3f} GiB over run 1 (the stacked batches, the "
              f"programs' pools)")
        del tr, data
    finally:
        functorch._set_vmap_fallback_enabled(was)
    torch.cuda.empty_cache()
    return out


#: Phase 8c: the buffered driver's commits a cell (num_rounds counts
#: commits): the degenerate cells, the asynchronous ones, the lossy
#: uplink, the duplicates and the Sent140 LSTM; the async cells' idle
#: share over BUF_PROFILED commits.  Cut for the script's time: the
#: async and int8 cells from 10 and 5 commits (their CPU path, three
#: runs for the nudge spread, took 49, 39 and ~25 s there), the
#: duplicates cell from 3 (the python driver it is held to solves its
#: duplicates one client at a time, ~25 s a round on the card).
BUF_DEGENERATE = 3
BUF_ASYNC = 5
BUF_INT8 = 3
BUF_DUP = 1
BUF_SENT140 = 2
BUF_PROFILED = 3
#: The history lists of the event stream (all but the loss): the host
#: computes them alone, so the card's run must give the CPU's exactly.
EVENT_KEYS = ("round", "comm_rounds", "intended_k", "effective_k",
              "dropped", "staleness_mean", "staleness_max", "buffer_wait",
              "anchor_age", "sim_time", "bytes_up", "bytes_down")


class BufferedRecorder:
    """Records a buffered trainer's cohort launches (cohort, gather
    selection) and cohort solves (the stacked ``(rows, nb)`` of each),
    by wrapping its driver's ``_launch`` and ``_solve_cohort``: one K2
    launch a solve under ``auto`` on logistic regression, and one K1
    launch a local step (``nb`` steps at E=1) on the LSTM."""

    def __init__(self, trainer):
        drv = trainer._buffered
        self.launches, self.solves = [], []
        launch, solve = drv._launch, drv._solve_cohort

        def spy_launch(cohort, s1, *a):
            self.launches.append((np.array(cohort), None if s1 is None
                                  else np.array(s1)))
            return launch(cohort, s1, *a)

        def spy_solve(w, corr, mu, b, v, limit):
            self.solves.append(tuple(v.shape))
            return solve(w, corr, mu, b, v, limit)

        drv._launch, drv._solve_cohort = spy_launch, spy_solve

    def clear(self):
        self.launches.clear()
        self.solves.clear()
        return self


def _buffered_cfg(**kw):
    from repro_torch.configs.base import FederatedConfig
    return FederatedConfig(mu=0.001, round_driver="buffered",
                           **dict(PAPER, **kw))


def buffered_cells():
    """Phase 8c's cells held to the CPU path: label -> (cfg, commits,
    runs); the degenerate cells take the run from the zero start, the
    others :data:`NUDGES`' three."""
    cells = {}
    for algo in ("feddane", "fedprox", "fedavg"):
        cells[f"buffered {algo} degenerate"] = (_buffered_cfg(
            algorithm=algo, buffer_size=0, staleness_fn="constant"),
            BUF_DEGENERATE, 1)
    for algo in ("feddane", "fedavg"):
        cells[f"buffered {algo} hostile M=5"] = (_buffered_cfg(
            algorithm=algo, scenario="hostile", buffer_size=5,
            staleness_fn="polynomial", max_staleness=3), BUF_ASYNC, 3)
    cells["buffered feddane hostile int8 M=5"] = (_buffered_cfg(
        algorithm="feddane", scenario="hostile", codec="int8",
        buffer_size=5), BUF_INT8, 3)
    return cells


def buffered_run(torch, syn_cpu, cfg, commits: int, seed: int, eps: float):
    """``cfg`` on the CPU path's buffered driver (``fused_epoch``, the
    plain version of K2, the mode ``auto`` takes on the card) for
    ``commits`` commits from the seeded zero start nudged by ``eps``
    (:func:`nudged`): its history and params."""
    from repro_torch.core import FederatedTrainer
    from repro_torch.models.small import logreg_loss
    return FederatedTrainer(
        logreg_loss, syn_cpu,
        dataclasses.replace(cfg, local_solver="fused_epoch"),
        device="cpu").run(nudged(torch, _logreg_p0(torch, "cpu"), seed, eps),
                          commits)


def _pooled_buffered(recipe, cfg, commits, seed, eps):
    import torch
    return buffered_run(torch, cpu_data(recipe), cfg, commits, seed, eps)


def buffered_cpu_jobs(pool, nudge: float = 1e-7):
    """Phase 8c's CPU-path runs (:func:`buffered_cells`), submitted to
    ``pool`` on the paper's synthetic(1,1): label -> futures."""
    recipe = ("synthetic", PAPER["num_devices"], None)
    return {label: [pool.submit(_pooled_buffered, recipe, cfg, commits,
                                seed, k * nudge)
                    for seed, k in NUDGES[:runs]]
            for label, (cfg, commits, runs) in buffered_cells().items()}


def buffered_cpu(torch, futures):
    """The CPU path's runs of a cell (:func:`buffered_cpu_jobs`): the
    first run's history and params, the larger move of the nudged runs,
    max |param| and the seconds spent waiting for them."""
    from repro_torch.core import pytree as pt

    runs, waited = results(futures)
    (hist, params), nudged_runs = runs[0], runs[1:]
    spread = max(max_err(torch, params, p) for _, p in nudged_runs)
    scale = max(float(x.abs().max()) for x in pt.leaves(params))
    return hist, params, spread, scale, waited


def _rel_loss(a, b) -> float:
    """Max |a - b| / max(1, |b|) over two loss histories."""
    return float(max(abs(x - y) / max(1.0, abs(y)) for x, y in zip(a, b)))


def buffered_phase(torch, counts, syn, python_ms, sent140, cpu_jobs):
    """Phase 8c: the buffered driver on the card.  ``python_ms``: phase
    7's python-driver ms/round of feddane under ``hostile``; ``sent140``:
    phase 8's handoff; ``cpu_jobs``: :func:`buffered_cpu_jobs`.  Returns
    ms/commit of the timed cells."""
    import torch._C._functorch as functorch
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.data.batching import FederatedData
    from repro_torch.models.small import logreg_loss, sentlstm_loss

    out = {}
    cells = buffered_cells()

    def card_run(cfg, commits, label, timed=False):
        """The card's run of ``cfg``: history, params on the CPU, ms a
        commit (CUDA events around ``run``), launches, recorder."""
        tr = FederatedTrainer(logreg_loss, syn, cfg)
        check(tr._resolve_driver() == "buffered", f"{label}: not buffered")
        rec = BufferedRecorder(tr)
        before = dict(counts)
        hist, params, ms = _timed_run(torch, tr, commits,
                                      params=_logreg_p0(torch))
        grew = _delta(before, counts)
        check(grew.get("local_epoch", 0) == len(rec.solves)
              and len(rec.solves) >= len(rec.launches) > 0,
              f"{label}: K2 launched {grew.get('local_epoch', 0)} times "
              f"for {len(rec.solves)} cohort solves ({len(rec.launches)} "
              f"launches)")
        check(not grew.get("codec_aggregate"),
              f"{label}: K5 launched in a buffered commit: {grew}")
        check(all(np.isfinite(hist["loss"])), f"{label}: loss not finite")
        return tr, hist, pt.tmap(lambda x: x.cpu(), params), ms, grew, rec

    # (a) degenerate: M = K, ideal, constant weights -- each commit a
    # synchronous round: the card's python driver and the CPU path's
    # buffered driver, the same seed
    for algo in ("feddane", "fedprox", "fedavg"):
        t_cell = time.perf_counter()
        label = f"buffered {algo} degenerate"
        cfg = cells[label][0]
        _, hg, pg, ms, grew, rec = card_run(cfg, BUF_DEGENERATE, label)
        hp, pp = FederatedTrainer(
            logreg_loss, syn, dataclasses.replace(
                cfg, round_driver="python")).run(_logreg_p0(torch),
                                                 BUF_DEGENERATE)
        pp = pt.tmap(lambda x: x.cpu(), pp)
        [(hc, pc)], _ = results(cpu_jobs[label])
        e_py, e_cpu = max_err(torch, pg, pp), max_err(torch, pg, pc)
        l_py, l_cpu = _rel_loss(hg["loss"], hp["loss"]), _rel_loss(
            hg["loss"], hc["loss"])
        check(max(e_py, e_cpu, l_py, l_cpu) <= TRAJECTORY_TOL,
              f"{label}: params {e_py} / {e_cpu}, loss {l_py} / {l_cpu} "
              f"from the card's python driver / the CPU buffered driver "
              f"> {TRAJECTORY_TOL}")
        check(all(hg[k] == hc[k] for k in EVENT_KEYS),
              f"{label}: history differs from the CPU buffered driver's")
        check(hg["staleness_max"] == [0.0] * BUF_DEGENERATE and
              hg["sim_time"] == [float(t + 1) for t in
                                 range(BUF_DEGENERATE)],
              f"{label}: staleness {hg['staleness_max']}, sim_time "
              f"{hg['sim_time']}")
        check(grew.get("local_epoch") == BUF_DEGENERATE,
              f"{label}: {grew} (K2 once a commit)")
        print(f"  {label}, {BUF_DEGENERATE} commits: {ms:.2f} ms/commit "
              f"(CUDA events, the first run); against the card's python "
              f"driver max |params| {e_py:.2e}, loss {l_py:.2e}; against "
              f"the CPU buffered driver {e_cpu:.2e}, {l_cpu:.2e} (tol "
              f"{TRAJECTORY_TOL:g}); staleness 0, sim_time "
              f"{hg['sim_time']}; launches {grew}; the cell "
              f"{time.perf_counter() - t_cell:.1f} s")

    # (b) asynchronous: hostile, M=5, polynomial weights, max staleness 3
    for algo in ("feddane", "fedavg"):
        label = f"buffered {algo} hostile M=5"
        cfg = cells[label][0]
        t0 = time.perf_counter()
        hc, pc, spread, scale, waited = buffered_cpu(torch, cpu_jobs[label])
        tol = SPREAD_FACTOR * spread if spread > 0 else TRAJECTORY_TOL
        print(f"  {label}: CPU path, {BUF_ASYNC} commits x 3 runs in the "
              f"pool (waited {waited:.1f} s); a 1e-7 nudge of w0 moves "
              f"params by {spread:.2e}; max |param| {scale:.3g}; card held "
              f"to {tol:.2e}")
        check(tol <= MAX_REL_LIMIT * scale,
              f"{label}: limit {tol} exceeds {MAX_REL_LIMIT} x {scale}")
        tr, h1, p1, ms1, grew, rec = card_run(cfg, BUF_ASYNC, label)
        solves = list(rec.solves)
        launches = len(rec.launches)
        _, h2, p2, ms2, _, _ = card_run(cfg, BUF_ASYNC, label)
        check(h1 == h2 and all(torch.equal(a, b) for a, b in
                               zip(pt.leaves(p1), pt.leaves(p2))),
              f"{label}: two card runs differ")
        bad = [k for k in EVENT_KEYS if h1[k] != hc[k]]
        check(not bad, f"{label}: {bad} differ from the CPU path's")
        err = max_err(torch, p1, pc)
        check(err <= tol, f"{label}: params {err} > {tol}")
        rate = BUF_ASYNC / h1["sim_time"][-1]
        out[f"buffered {algo} hostile"] = ms2
        print(f"    card: run 1 {ms1:.2f}, run 2 {ms2:.2f} ms/commit (CUDA "
              f"events), bitwise equal; {rate:.3f} commits per unit of "
              f"simulated time (sim_time {h1['sim_time'][-1]:.3f}); "
              f"{launches} cohort launches, {len(solves)} K2 launches at K "
              f"= {sorted({k for k, _ in solves})}; phase 7's python "
              f"driver on feddane hostile {python_ms:.2f} ms/round")
        print(f"    event stream equal to the CPU path's: staleness max "
              f"{h1['staleness_max']}, dropped {h1['dropped']}; max "
              f"|params card - cpu| {err:.2e} (limit {tol:.2e}); loss "
              f"{[round(x, 4) for x in h1['loss']]}")
        device_share(torch, lambda: tr.run(_logreg_p0(torch), BUF_PROFILED),
                     f"{label}, {BUF_PROFILED} commits")
        print(f"    the cell {time.perf_counter() - t0:.1f} s")

    # (c) lossy uplink: int8 encoded at launch, decoded deltas committed
    t_cell = time.perf_counter()
    label = "buffered feddane hostile int8 M=5"
    cfg = cells[label][0]
    hc, pc, spread, scale, _ = buffered_cpu(torch, cpu_jobs[label])
    tol = SPREAD_FACTOR * spread if spread > 0 else TRAJECTORY_TOL
    check(tol <= MAX_REL_LIMIT * scale,
          f"{label}: limit {tol} exceeds {MAX_REL_LIMIT} x {scale}")
    _, hg, pg, ms, grew, rec = card_run(cfg, BUF_INT8, label)
    bad = [k for k in EVENT_KEYS if hg[k] != hc[k]]
    check(not bad, f"{label}: {bad} differ from the CPU path's")
    err = max_err(torch, pg, pc)
    check(err <= tol, f"{label}: params {err} > {tol}")
    print(f"  {label}, {BUF_INT8} commits: {ms:.2f} ms/commit; event "
          f"stream equal to the CPU path's; max |params| {err:.2e} (limit "
          f"{SPREAD_FACTOR:g} x the nudge spread {spread:.2e}); K5 not "
          f"launched; launches {grew}; the cell "
          f"{time.perf_counter() - t_cell:.1f} s")

    # (d) duplicates: scaffold with replacement, occurrence layers
    t_cell = time.perf_counter()
    label = "buffered scaffold with replacement"
    cfg = _buffered_cfg(algorithm="scaffold", sample_with_replacement=True)
    _, hg, pg, ms, grew, rec = card_run(cfg, BUF_DUP, label)
    check(len(rec.solves) > len(rec.launches),
          f"{label}: no cohort held a client twice: {rec.solves}")
    hp, pp = FederatedTrainer(logreg_loss, syn, dataclasses.replace(
        cfg, round_driver="python")).run(_logreg_p0(torch), BUF_DUP)
    err = max_err(torch, pg, pt.tmap(lambda x: x.cpu(), pp))
    dl = _rel_loss(hg["loss"], hp["loss"])
    check(err <= TRAJECTORY_TOL and dl <= TRAJECTORY_TOL,
          f"{label}: params {err}, loss {dl} from the card's python "
          f"driver > {TRAJECTORY_TOL}")
    print(f"  {label}, {BUF_DUP} commits: {ms:.2f} ms/commit; "
          f"{len(rec.launches)} cohort launches solved in "
          f"{len(rec.solves)} occurrence layers (rows {[k for k, _ in rec.solves]}"
          f"), one K2 launch each; against the card's python driver max "
          f"|params| {err:.2e}, loss {dl:.2e}; launches {grew}; the cell "
          f"{time.perf_counter() - t_cell:.1f} s")

    # (e) the Sent140-like LSTM (phase 8's settings), M = K, ideal: the
    # card's python driver of phase 8, the same seed and selections
    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        label = "buffered sent140 feddane"
        data = FederatedData(sent140["devs"], 10, name="sent140_like",
                             eval_sample=LOSS_DEVICES)
        cfg = dataclasses.replace(sent140["cfg"], round_driver="buffered",
                                  buffer_size=0)
        tr = FederatedTrainer(sentlstm_loss, data, cfg)
        rec = BufferedRecorder(tr)
        before = dict(counts)
        h, p, ms = _timed_run(torch, tr, BUF_SENT140, params=sent140["p0"])
        grew = _delta(before, counts)
        for (cohort, s1), (_, sel, _) in zip(rec.launches,
                                             sent140["rounds"]):
            check(np.array_equal(s1, sel[0]) and
                  np.array_equal(cohort, sel[1]),
                  f"{label}: selections differ from phase 8's")
        limit = sent140["rounds"][BUF_SENT140 - 1][2]
        err = max_err(torch, pt.tmap(lambda x: x.cpu(), p), sent140["card"])
        check(err <= limit, f"{label}: params differ from phase 8's python "
                            f"driver by {err} > {limit}")
        steps = sum(cfg.local_epochs * nb for _, nb in rec.solves)
        check(grew.get("dane_update_flat") == steps and
              not grew.get("local_epoch"),
              f"{label}: {grew} for {steps} local steps (K1 once a step)")
        check(all(np.isfinite(h["loss"])), f"{label}: loss not finite")
        out["buffered sent140 feddane"] = ms
        print(f"  {label}, {BUF_SENT140} commits: {ms:.2f} ms/commit (CUDA "
              f"events); phase 8's python driver "
              f"{[round(m, 2) for m in sent140['ms']]} ms/round; the same "
              f"selections; max |params - phase 8's card params| "
              f"{err:.2e} (limit {limit:.2e}); {steps} local steps, "
              f"launches {grew}")
        del tr, data
    finally:
        functorch._set_vmap_fallback_enabled(was)
    torch.cuda.empty_cache()
    return out


#: Phase 8d: the population layer at the reference's acceptance settings
#: (tests/_population_child.py): N=10^6 streaming synthetic(1,1), K=10,
#: E=1, B=10, lr=0.05, mu=0.01, seed 5, the eval over 32 clients.
POP = dict(num_devices=1_000_000, devices_per_round=10, local_epochs=1,
           local_batch_size=10, learning_rate=0.05, mu=0.01, seed=5)
POP_ROUNDS = 3
POP_SCAFFOLD_ROUNDS = 2
#: the reference's directional cell (tests/test_population.py)
POP_DIRECTIONAL_ROUNDS = 4
#: at most the eval sample plus two phases x K x rounds cohort fetches
POP_MAX_CLIENTS = 32 + 2 * 10 * POP_ROUNDS
POP_MAX_CARD_BYTES = 256 << 20


def _proc_mb(field: str) -> float:
    """This process's ``VmRSS`` or ``VmHWM`` in MB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


class Footprint:
    """The card's peak allocated bytes above what was allocated when the
    block began (the peak counter reset there) and the host's peak RSS
    growth over the block: ``VmHWM`` reset through
    ``/proc/self/clear_refs`` where the kernel lets a process do that,
    else the largest ``VmRSS`` a thread samples every millisecond."""

    def __init__(self, torch):
        self.torch = torch

    def _sample(self):
        page = os.sysconf("SC_PAGE_SIZE") / 2**20
        with open("/proc/self/statm") as f:
            while not self._stop.wait(0.001):
                f.seek(0)
                self._peak = max(self._peak, int(f.read().split()[1]) * page)

    def __enter__(self):
        import gc
        import threading
        gc.collect()
        self.torch.cuda.synchronize()
        self.torch.cuda.empty_cache()
        self.base = self.torch.cuda.memory_allocated()
        self.torch.cuda.reset_peak_memory_stats()
        self.rss0 = self._peak = _proc_mb("VmRSS")
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            self.how = "VmHWM"
        except OSError:
            self.how = "VmRSS sampled every 1 ms"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self._stop.set()
        self._thread.join(timeout=5)
        self.card = self.torch.cuda.max_memory_allocated() - self.base
        peak = (_proc_mb("VmHWM") if self.how == "VmHWM"
                else max(self._peak, _proc_mb("VmRSS")))
        self.rss = peak - self.rss0

    def __str__(self):
        return (f"card peak allocated +{self.card / 2**20:.2f} MiB; host "
                f"peak RSS +{self.rss:.1f} MB ({self.how})")


def _pop_source(device=None):
    """The population cell's streaming source, on the card by default."""
    from repro_torch.data import make_synthetic_stream
    return make_synthetic_stream(1.0, 1.0, num_devices=POP["num_devices"],
                                 seed=7, eval_clients=32, device=device)


def population_phase(torch, counts):
    """Phase 8d: the population layer.  Returns ms/round of its cells."""
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import FederatedTrainer, engine
    from repro_torch.core import pytree as pt
    from repro_torch.data import make_synthetic_stream
    from repro_torch.models.small import logreg_loss

    out = {}
    on_cpu = dict(engine="batched", local_solver="fused_epoch")
    phase_before = dict(counts)

    def cpu_path(algo, rounds):
        src = _pop_source("cpu")
        tr = FederatedTrainer(logreg_loss, src, FederatedConfig(
            algorithm=algo, round_driver="python", **on_cpu, **POP),
            device="cpu")
        st = tr.init(_logreg_p0(torch, "cpu"))
        traj = []
        for _ in range(rounds):
            st = tr.round(st)
            traj.append((pt.tmap(torch.clone, st.params),
                         tr.last_selection, tr.global_loss(st.params)))
        return traj, src

    def clients(src, label):
        got = src.stats()["materialized_clients"]
        check(got <= POP_MAX_CLIENTS, f"{label}: {got} clients generated "
                                      f"> {POP_MAX_CLIENTS}")
        return int(got)

    def fits(fp, label):
        check(fp.card < POP_MAX_CARD_BYTES,
              f"{label}: card peak +{fp.card} bytes >= 256 MiB")

    # (a) feddane at N=10^6 on the python driver (batched on the card)
    traj, csrc = cpu_path("feddane", POP_ROUNDS)
    src = _pop_source()
    tr = FederatedTrainer(logreg_loss, src, FederatedConfig(
        algorithm="feddane", round_driver="python", **POP))
    before = dict(counts)
    ms, errs = [], []
    with Footprint(torch) as fp:
        st = tr.init(_logreg_p0(torch))
        for r in range(POP_ROUNDS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            st = tr.round(st)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            for a, b in zip(tr.last_selection, traj[r][1]):
                check(np.array_equal(a, b),
                      "population python: selections differ from the CPU "
                      "path's")
            errs.append(max_err(torch, pt.tmap(lambda x: x.cpu(),
                                               st.params), traj[r][0]))
            check(errs[-1] <= TRAJECTORY_TOL,
                  f"population python: params {errs[-1]} > "
                  f"{TRAJECTORY_TOL}")
        loss = tr.global_loss(st.params)
    grew = _delta(before, counts)
    check(grew.get("local_epoch") == POP_ROUNDS,
          f"population python: launches {grew}, not K2 once a round")
    check(abs(loss - traj[-1][2]) <= TRAJECTORY_TOL * max(1.0, abs(loss)),
          f"population python: loss {loss} against {traj[-1][2]}")
    fits(fp, "population python")
    out["population python feddane"] = statistics.median(ms)
    print(f"  N=10^6 feddane, python driver, {POP_ROUNDS} rounds: ms/round "
          f"{[round(m, 2) for m in ms]} (CUDA events); the CPU path's "
          f"selections; max |params - CPU| per round "
          f"{[f'{e:.2e}' for e in errs]} (tol {TRAJECTORY_TOL:g}); loss "
          f"{loss:.6f} (CPU {traj[-1][2]:.6f}); launches {grew}; "
          f"{clients(src, 'population python')} clients generated "
          f"(CPU {clients(csrc, 'population cpu')}); {fp}")

    # (b) the scanned driver's streaming plan on the CPU path's selections
    sel = np.stack([np.stack(t[1]) for t in traj])
    src = _pop_source()
    tr = FederatedTrainer(logreg_loss, src, FederatedConfig(
        algorithm="feddane", round_driver="scan", client_source="streaming",
        chunk_rounds=POP_ROUNDS, **POP))
    check(tr._resolve_driver() == "scan", "population scan: not on scan")
    before = dict(counts)
    with Footprint(torch) as fp:
        t0 = time.perf_counter()
        h1, p1 = tr.run(_logreg_p0(torch), POP_ROUNDS,
                        eval_every=POP_ROUNDS, selections=sel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    grew = _delta(before, counts)
    drv = tr._scanned
    check(drv.streaming and drv.batches_all is None,
          "population scan: not the streaming plan")
    err = max_err(torch, pt.tmap(lambda x: x.cpu(), p1), traj[-1][0])
    check(err <= TRAJECTORY_TOL,
          f"population scan: params {err} from the CPU path > "
          f"{TRAJECTORY_TOL}")
    check(abs(h1["loss"][-1] - traj[-1][2])
          <= TRAJECTORY_TOL * max(1.0, abs(traj[-1][2])),
          f"population scan: loss {h1['loss']} against {traj[-1][2]}")
    caps = drv.stream_captures
    check(grew.get("local_epoch") == POP_ROUNDS + caps,
          f"population scan: launches {grew} (K2 once a replay plus each "
          f"capture's warm-up)")
    fits(fp, "population scan")
    h2, p2, ms = _timed_run(torch, tr, POP_ROUNDS,
                            params=_logreg_p0(torch),
                            eval_every=POP_ROUNDS, selections=sel)
    check(h1 == h2 and all(torch.equal(a, b) for a, b in
                           zip(pt.leaves(p1), pt.leaves(p2))),
          "population scan: two runs differ")
    out["population scan feddane"] = ms
    print(f"  N=10^6 feddane, scanned driver (streaming), {POP_ROUNDS} "
          f"rounds on the CPU path's selections: run 1 {wall:.2f} s (host "
          f"clock, {caps} streaming capture(s), batch counts "
          f"{sorted(drv._sbufs)}; captured {_programs(tr)}), run 2 "
          f"{ms:.3f} ms/round (CUDA events), bitwise equal; max |params - "
          f"CPU| {err:.2e}; loss {h1['loss'][-1]:.6f}; launches {grew}; "
          f"{clients(src, 'population scan')} clients generated; {fp}")

    # (c) buffered, 3 commits, against the CPU buffered driver
    cfg = FederatedConfig(algorithm="feddane", round_driver="buffered",
                          **POP)
    hc, pc = FederatedTrainer(
        logreg_loss, _pop_source("cpu"),
        dataclasses.replace(cfg, local_solver="fused_epoch"),
        device="cpu").run(_logreg_p0(torch, "cpu"), POP_ROUNDS)
    src = _pop_source()
    tr = FederatedTrainer(logreg_loss, src, cfg)
    before = dict(counts)
    with Footprint(torch) as fp:
        hg, pg, ms = _timed_run(torch, tr, POP_ROUNDS,
                                params=_logreg_p0(torch))
    grew = _delta(before, counts)
    err = max_err(torch, pt.tmap(lambda x: x.cpu(), pg), pc)
    check(all(hg[k] == hc[k] for k in hc if k != "loss"),
          "population buffered: event stream differs from the CPU path's")
    check(err <= TRAJECTORY_TOL and _rel_loss(hg["loss"], hc["loss"])
          <= TRAJECTORY_TOL, f"population buffered: params {err}")
    check(grew.get("local_epoch", 0) > 0, f"population buffered: {grew}")
    fits(fp, "population buffered")
    out["population buffered feddane"] = ms
    print(f"  N=10^6 feddane, buffered driver, {POP_ROUNDS} commits: "
          f"{ms:.2f} ms/commit (CUDA events); event stream equal to the "
          f"CPU path's; max |params - CPU| {err:.2e}; launches {grew}; "
          f"{clients(src, 'population buffered')} clients generated; {fp}")

    # (d) SCAFFOLD: the controls in the sparse store
    traj, _ = cpu_path("scaffold", POP_SCAFFOLD_ROUNDS)
    src = _pop_source()
    tr = FederatedTrainer(logreg_loss, src, FederatedConfig(
        algorithm="scaffold", round_driver="python", **POP))
    before = dict(counts)
    with Footprint(torch) as fp:
        st = tr.init(_logreg_p0(torch))
        for _ in range(POP_SCAFFOLD_ROUNDS):
            st = tr.round(st)
    grew = _delta(before, counts)
    err = max_err(torch, pt.tmap(lambda x: x.cpu(), st.params),
                  traj[-1][0])
    check(err <= TRAJECTORY_TOL, f"population scaffold: params {err}")
    stored = len(st.controls)
    check(stored <= 2 * 10 and st.controls.peak_clients <= 2 * 10,
          f"population scaffold: {stored} controls stored")
    check(grew.get("local_epoch") == POP_SCAFFOLD_ROUNDS,
          f"population scaffold: {grew}")
    fits(fp, "population scaffold")
    print(f"  N=10^6 scaffold, python driver, {POP_SCAFFOLD_ROUNDS} rounds: "
          f"{stored} controls stored (peak {st.controls.peak_clients}); "
          f"max |params - CPU| {err:.2e}; launches {grew}; {fp}")

    # (e) streaming against stacked on the card, sampled selections
    small = make_synthetic_stream(1, 1)
    staged = []
    stage = engine.ScannedDriver._stream_stage

    def spy_stage(self, off, rows, wire_rows):
        staged.extend(np.stack([r["s1"], r["sel_solve"]]) for r in rows)
        return stage(self, off, rows, wire_rows)

    runs = {}
    before = dict(counts)
    for plan in ("streaming", "stacked"):
        cfg = FederatedConfig(algorithm="feddane", round_driver="scan",
                              client_source=plan, chunk_rounds=POP_ROUNDS,
                              **dict(POP, num_devices=30))
        tr = FederatedTrainer(logreg_loss, small, cfg)
        rec = None
        if plan == "streaming":
            engine.ScannedDriver._stream_stage = spy_stage
            try:
                h, p = tr.run(_logreg_p0(torch), POP_ROUNDS)
            finally:
                engine.ScannedDriver._stream_stage = stage
        else:
            # the stacked plan draws inside its captured round
            rec = ScanRecorder(torch, POP_ROUNDS, 10, small.device,
                               2).bind(tr)
            with rec:
                h, p = tr.run(_logreg_p0(torch), POP_ROUNDS)
            rec = rec.numpy()["sel"]
        runs[plan] = (h, pt.tmap(lambda x: x.cpu(), p), rec, tr._scanned)
    (hs, ps, _, ds), (ht, pt_, rt, dt) = runs["streaming"], runs["stacked"]
    sel_s = np.stack(staged)
    check(ds.streaming and not dt.streaming, "population N=30: plans")
    check(np.array_equal(sel_s, rt) and (rt >= 0).all(),
          "population N=30: streaming selections differ from the stacked "
          "plan's (eager draws against graph replays)")
    err = max_err(torch, ps, pt_)
    check(err <= 1e-5, f"population N=30: params {err} > 1e-5")
    check(all(hs[k] == ht[k] for k in ht if k != "loss"),
          "population N=30: history differs")
    print(f"  N=30 feddane, {POP_ROUNDS} sampled rounds: the streaming "
          f"schedule's eager draws equal the stacked plan's in-graph draws "
          f"bit for bit ({len({s.tobytes() for s in sel_s})} distinct); max "
          f"|params streaming - stacked| {err:.2e} (tol 1e-5); launches "
          f"{_delta(before, counts)}")

    # (f) the paper's finding at K/N = 1e-5 under bernoulli
    src = _pop_source()
    finals = {}
    before = dict(counts)
    for algo in ("fedavg", "fedprox", "feddane"):
        cfg = FederatedConfig(algorithm=algo, round_driver="scan",
                              chunk_rounds=POP_DIRECTIONAL_ROUNDS,
                              scenario="bernoulli", **POP)
        h, _ = FederatedTrainer(logreg_loss, src, cfg).run(
            _logreg_p0(torch), POP_DIRECTIONAL_ROUNDS,
            eval_every=POP_DIRECTIONAL_ROUNDS)
        finals[algo] = h["loss"][-1]
        check(np.isfinite(finals[algo]), f"population {algo}: not finite")
    worse = all(finals["feddane"] > 1.5 * finals[a]
                for a in ("fedavg", "fedprox"))
    print(f"  N=10^6 bernoulli, {POP_DIRECTIONAL_ROUNDS} scanned rounds "
          f"(K/N = 1e-5): final loss "
          f"{ {k: round(v, 4) for k, v in finals.items()} }; feddane > 1.5x "
          f"both: {'yes' if worse else 'no'}; launches "
          f"{_delta(before, counts)}")
    print(f"  phase 8d launches {_delta(phase_before, counts)}")
    torch.cuda.empty_cache()
    return out


#: Phase 9: (ranks, edges) -> cells (driver, algorithm, scenario, codec).
#: The flat mesh splits K=10 into two ranks of 5 clients; the tree puts
#: one client on each of 10 ranks under 2 edges of 5 leaves.  Drivers:
#: ``python`` (``MESH_ROUNDS`` rounds), ``scan`` (sampled on the card,
#: run twice: the captures, then the timed replays), ``scan_injected``
#: (numpy-seeded selections), ``buffered`` (``hostile``: M=5), and the
#: N=10^6 streaming source of phase 8d (``POP``) on ``stream_python`` and
#: ``stream_scan``.
MESH_CELLS = {(2, 1): [("python", "feddane", "ideal", "none"),
                       ("python", "scaffold", "ideal", "none"),
                       ("python", "fedavg", "ideal", "topk"),
                       ("scan", "feddane", "ideal", "none"),
                       ("scan_injected", "scaffold", "ideal", "none"),
                       ("buffered", "feddane", "hostile", "none"),
                       ("stream_python", "feddane", "ideal", "none"),
                       ("stream_scan", "feddane", "ideal", "none")],
              (10, 2): [("python", "feddane", "hostile", "int8"),
                        ("scan", "feddane", "hostile", "int8"),
                        ("buffered", "feddane", "ideal", "none")]}
MESH_ROUNDS = 3
#: rounds (commits) of each driver's cells; the (2, 1) scan cell runs 5
MESH_SCAN_ROUNDS = {(2, 1): 5, (10, 2): 3}
MESH_BUF_COMMITS = {"hostile": 5, "ideal": 3}
MESH_STREAM_ROUNDS = 2
MESH_BUF_M = 5


def mesh_config(driver: str, algo: str, scenario: str, codec_name: str,
                **kw):
    from repro_torch.configs.base import FederatedConfig
    if driver.startswith("stream"):
        return FederatedConfig(algorithm=algo, round_driver=driver[7:],
                               client_source="streaming", **POP, **kw)
    extra = dict(buffer_size=MESH_BUF_M) if (
        driver == "buffered" and scenario == "hostile") else {}
    return FederatedConfig(
        algorithm=algo, mu=0.001, scenario=scenario, codec=codec_name,
        round_driver={"scan_injected": "scan"}.get(driver, driver),
        **PAPER, **extra, **kw)


def drive(torch, trainer, rounds: int, counts=None):
    """``rounds`` rounds of ``trainer`` from the seeded zero start: each
    round's selections, masks and effective K, CUDA-event ms and loss,
    then the final params and per-client state as numpy, and the launch
    counts of the run when ``counts`` (the counters) is given."""
    from repro_torch.models.param import init_params
    from repro_torch.models.small import logreg_specs

    st = trainer.init(init_params(logreg_specs(60, 10),
                                  torch.Generator().manual_seed(0),
                                  device=trainer.device))
    if counts is not None:
        for k in counts:
            counts[k] = 0                 # this rank's path starts here
    rec = {"sel": [], "masks": [], "eff_k": [], "ms": [], "loss": []}
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        st = trainer.round(st)
        end.record()
        end.synchronize()
        rec["ms"].append(start.elapsed_time(end))
        rec["sel"].append([np.asarray(s) for s in trainer.last_selection])
        rec["masks"].append(trainer.last_masks)
        rec["eff_k"].append(trainer.last_env[1])
        rec["loss"].append(trainer.global_loss(st.params))
    if counts is not None:
        rec["launches"] = dict(counts)    # and is read here
    rec["params"] = {k: v.cpu().numpy() for k, v in st.params.items()}
    for f in ("controls", "ef"):
        store = getattr(st, f)
        rec[f] = (None if store is None else [
            {k: v.cpu().numpy() for k, v in (
                row.items() if isinstance(row, dict) else [("x", row)])}
            for row in store.to_dense()])
    return rec


class SampleSpy:
    """Records every draw of the host and card samplers while active, in
    order, as numpy (the streaming plans draw eagerly)."""

    def __init__(self):
        self.sel = []

    def __enter__(self):
        from repro_torch.core import server
        self._saved = (server.sample_devices, server.sample_devices_onchip)

        def spy(fn):
            def f(*a, **k):
                out = fn(*a, **k)
                self.sel.append(out.cpu().numpy() if hasattr(out, "cpu")
                                else np.array(out))
                return out
            return f

        server.sample_devices, server.sample_devices_onchip = map(
            spy, self._saved)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import server
        server.sample_devices, server.sample_devices_onchip = self._saved


def replay_breakdown(torch, drv) -> Optional[Tuple[float, float, float,
                                                    int]]:
    """One more replay of the scanned driver ``drv``'s round program on
    its first staged row, step by step between host syncs: the host ms
    in its CUDA-graph segments, in the all-reduces between them, and in
    the largest all-reduce step with its bytes (on feddane the cohort's
    batch gather); the replay's launches are not counted: it only
    measures.  ``None`` where nothing was captured (the CPU)."""
    names = [k for k in drv._programs if k != "eval"]
    if not names:
        return None
    drv._ctr.zero_()
    seg = red = big_ms = 0.0
    big = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for kind, nbytes in drv._programs[names[0]].graph.replay_steps():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dt, t0 = (t1 - t0) * 1e3, t1
        if kind == "segment":
            seg += dt
            continue
        red += dt
        if nbytes > big:
            big, big_ms = nbytes, dt
    return seg, red, big_ms, big


def mesh_cell(torch, cell, rounds: int, mesh=None, counts=None):
    """One phase-9 cell on this rank of ``mesh`` (or in one process with
    ``mesh=None``): a record of its selections, masks, effective K, loss,
    params, ms per round (or commit) and, given ``counts``, the launches
    of the cell (the counters set to 0 just before it, read just after),
    with the segments of each captured program."""
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.data import make_synthetic
    from repro_torch.models.small import logreg_loss

    driver, algo, scenario, codec_name = cell
    kw = ({} if mesh is None else dict(mesh_devices=mesh.world,
                                       edge_shards=mesh.edge_shards))
    cfg = mesh_config(driver, algo, scenario, codec_name, **kw)
    streaming = driver.startswith("stream")
    dev = None if mesh is None else mesh.device
    data = (_pop_source(dev) if streaming else make_synthetic(
        1, 1, num_devices=30, seed=0, batch_size=10, device=dev))
    tr = FederatedTrainer(logreg_loss, data, cfg, mesh=mesh)
    if driver == "python":
        return drive(torch, tr, rounds, counts)
    if counts is not None:
        for k in counts:
            counts[k] = 0                 # this rank's cell starts here
    rec = {"masks": None, "segments": None}
    p0 = _logreg_p0(torch, tr.device)
    fp = Footprint(torch) if streaming else contextlib.nullcontext()
    if driver == "stream_python":
        with fp, SampleSpy() as spy:
            rec.update(drive(torch, tr, rounds))
        rec["sel"] = spy.sel
        rec["ms_all"] = rec["ms"]
    elif driver == "buffered":
        bufrec = BufferedRecorder(tr)
        hist, params, ms = _timed_run(torch, tr, rounds, params=p0)
        rec.update(sel=[[np.asarray(c), s1] for c, s1 in bufrec.launches],
                   solves=bufrec.solves, ms_all=[ms],
                   events={k: hist[k] for k in EVENT_KEYS})
    else:
        # the scanned driver: run 1 captures its programs, run 2 replays
        # them, timed; both bitwise equal
        sel = None
        if driver == "scan_injected":
            rng = np.random.default_rng(PAPER["seed"])
            sel = np.stack([np.stack([rng.choice(30, 10, replace=False)
                                      for _ in range(2)])
                            for _ in range(rounds)])
        recorder = (SampleSpy() if streaming else ScanRecorder(
            torch, rounds, 10, tr.device, 2).bind(tr))
        runs = []
        with fp:
            for _ in range(2):
                if streaming:
                    recorder.sel.clear()
                with recorder:
                    runs.append(_timed_run(torch, tr, rounds, params=p0,
                                           selections=sel))
        (hist, params, _), (h2, p2, ms) = runs
        check(hist == h2 and all(torch.equal(a, b) for a, b in zip(
            pt.leaves(params), pt.leaves(p2))),
            f"mesh {cell}: two runs differ")
        if sel is not None:
            rec["sel"] = list(sel)
        elif streaming:
            rec["sel"] = recorder.sel
        else:
            got = recorder.numpy()
            rec["sel"] = list(got["sel"])
            if scenario != "ideal":
                rec["masks"] = [(got["avail"][t], got["active"][t])
                                for t in range(rounds)]
        rec["ms_all"] = [ms]
        rec["sharded"] = hist.get("sharded")
        rec["segments"] = {k: (p.graph.segments, p.graph.collectives)
                           for k, p in tr._scanned._programs.items()}
        rec["breakdown"] = replay_breakdown(torch, tr._scanned)
    if driver != "stream_python":
        rec.update(eff_k=hist["effective_k"], loss=hist["loss"],
                   params={k: v.cpu().numpy() for k, v in params.items()})
    rec["ms"] = rec.pop("ms_all")
    if streaming:
        rec["clients"] = int(data.materialized_clients)
        rec["card_mib"] = fp.card / 2**20
    if counts is not None:
        rec["launches"] = dict(counts)    # and is read here
    return rec


def mesh_rank(mesh, cells, shape):
    """Phase 9 on one rank of the client mesh: every cell of ``cells``
    through this rank's own trainer, on the rank's device."""
    import torch
    from repro_torch.kernels import build
    return [mesh_cell(torch, cell, _mesh_rounds(cell, shape), mesh,
                      build.launch_counts) for cell in cells]


def _mesh_rounds(cell, shape) -> int:
    driver, _, scenario, _ = cell
    if driver == "buffered":
        return MESH_BUF_COMMITS[scenario]
    if driver.startswith("stream"):
        return MESH_STREAM_ROUNDS
    if driver == "scan":
        return MESH_SCAN_ROUNDS[shape]
    return MESH_ROUNDS


def _bits(rec):
    """A record's results as bytes, for bitwise comparison across ranks."""
    import pickle
    return pickle.dumps({k: rec.get(k) for k in (
        "params", "loss", "controls", "ef", "sel", "masks", "eff_k",
        "events", "sharded")})


def _same_masks(a, b) -> bool:
    """Two records' masks equal: ``None``, or per round ``None`` or a
    (phase-A availability, solve mask) pair."""
    if a is None or b is None:
        return a is None and b is None
    return len(a) == len(b) and all(
        (pa is None and pb is None) or (
            pa is not None and pb is not None and all(
                (x is None and y is None) or np.array_equal(x, y)
                for x, y in zip(pa, pb)))
        for pa, pb in zip(a, b))


def mesh_phase(torch, int8_tol: float):
    """Phase 9; returns the launches summed over every rank's cells."""
    from repro_torch.core.sharding import run_on_mesh

    print("    the ranks share cuda:0 over gloo: NCCL refuses two ranks "
          "on one device, and this run has one card")
    summed = {}
    for (d, e), cells in MESH_CELLS.items():
        t0 = time.perf_counter()
        res = run_on_mesh(mesh_rank, d, e, args=(cells, (d, e)),
                          device="cuda:0", backend="gloo")
        print(f"  {d} ranks under {e} edge(s): {time.perf_counter() - t0:.1f}"
              f" s, the ranks' start included")
        for i, cell in enumerate(cells):
            driver, algo, scenario, codec_name = cell
            rounds = _mesh_rounds(cell, (d, e))
            label = f"mesh {d}x{e} {driver} {algo}/{scenario}/{codec_name}"
            recs = [r[i] for r in res]
            for r, rec in enumerate(recs[1:], 1):
                check(_bits(rec) == _bits(recs[0]),
                      f"{label}: rank {r} differs from rank 0")
            one = mesh_cell(torch, cell, rounds)
            got = recs[0]
            check(len(got["sel"]) == len(one["sel"]) and all(
                np.array_equal(np.asarray(a), np.asarray(b))
                for x, y in zip(got["sel"], one["sel"])
                for a, b in zip(x if isinstance(x, list) else [x],
                                y if isinstance(y, list) else [y])
                if a is not None or b is not None),
                f"{label}: selections differ from the single process")
            check(_same_masks(got["masks"], one["masks"]),
                  f"{label}: masks differ from the single process")
            check(got["eff_k"] == one["eff_k"],
                  f"{label}: effective K {got['eff_k']} != {one['eff_k']}")
            if "events" in one:
                check(got["events"] == one["events"],
                      f"{label}: event stream differs from the single "
                      f"process's")
            err = max(float(np.abs(got["params"][k] - one["params"][k])
                            .max()) for k in got["params"])
            tol = int8_tol if codec_name == "int8" else TRAJECTORY_TOL
            check(err <= tol, f"{label}: params differ from the single "
                              f"process by {err} > {tol}")
            check(all(np.isfinite(got["loss"])), f"{label}: loss not finite")
            launches = {k: sum(r["launches"][k] for r in recs)
                        for k in recs[0]["launches"]}
            # K6 once a lossy round (a replay, and each capture's warm-up)
            # on every rank, K5 never
            lossy = 0
            if codec_name != "none":
                lossy = (MESH_ROUNDS if driver == "python"
                         else 1 + 2 * rounds)
            check(launches["codec_aggregate_partial"] == d * lossy,
                  f"{label}: {launches['codec_aggregate_partial']} K6 "
                  f"launches, not {d} ranks x {lossy} lossy rounds")
            check(launches["codec_aggregate"] == 0,
                  f"{label}: K5 launched in the ranks")
            check(launches["local_epoch"] > 0, f"{label}: K2 never launched")
            if driver.startswith("scan"):
                check(got["sharded"] == [1.0] * rounds,
                      f"{label}: sharded {got['sharded']}")
                rounds_prog = [v for k, v in got["segments"].items()
                               if k != "eval"]
                check(rounds_prog and all(s >= 2 for s, _ in rounds_prog),
                      f"{label}: round not split at its collectives "
                      f"{got['segments']}")
            if driver == "buffered":
                for (cohort, _), rows in zip(one["sel"], got["solves"]):
                    check(rows[0] == -(-len(cohort) // d),
                          f"{label}: a cohort of {len(cohort)} solved as "
                          f"{rows[0]} rows a rank")
            if driver.startswith("stream"):
                bound = 32 + MESH_STREAM_ROUNDS * 2 * 10 // d
                worst = max(r["clients"] for r in recs)
                check(worst <= bound, f"{label}: a rank generated {worst} "
                                      f"clients > {bound}")
            for k, v in launches.items():
                summed[k] = summed.get(k, 0) + v
            unit = "commit" if driver == "buffered" else "round"
            print(f"  {label}: ms/{unit} (rank 0) "
                  f"{[round(m, 3) for m in got['ms']]} (median "
                  f"{statistics.median(got['ms']):.3f}); single process "
                  f"{[round(m, 3) for m in one['ms']]}")
            print(f"    {d} ranks bitwise equal; selections, masks and "
                  f"effective K {got['eff_k']} equal the single process; "
                  f"max |params mesh - single| {err:.2e} (tol {tol:.3g}); "
                  f"loss {[round(x, 6) for x in got['loss']]}")
            extra = ""
            if got.get("breakdown") is not None:
                extra += (f"; (segments, all-reduces) a replay "
                          f"{got['segments']}; one replay step by step "
                          f"(host clock): segments "
                          f"{got['breakdown'][0]:.3f} ms, all-reduces "
                          f"{got['breakdown'][1]:.3f} ms, of which the "
                          f"largest step ({got['breakdown'][3]} bytes) "
                          f"{got['breakdown'][2]:.3f} ms (single process "
                          f"{one['breakdown'][0]:.3f} ms)")
            if driver == "buffered":
                extra += (f"; cohort sizes {[len(c) for c, _ in one['sel']]}"
                          f", rows a rank {[r[0] for r in got['solves']]}")
            if driver.startswith("stream"):
                extra += (f"; clients generated a rank "
                          f"{[r['clients'] for r in recs]} (single "
                          f"{one['clients']}); card peak a rank +"
                          f"{[round(r['card_mib'], 2) for r in recs]} MiB")
            print(f"    K2 {launches['local_epoch']} and K6 "
                  f"{launches['codec_aggregate_partial']} launches over the "
                  f"ranks; all { {k: v for k, v in launches.items() if v} }"
                  f"{extra}")
    return summed


def device_share(torch, fn, label: str, host_ops: bool = True):
    """One more call of ``fn`` (a round, a prefill) under
    ``torch.profiler``: its host-clock time (profiler on) against the
    summed time of the kernels and copies it ran on the card, i.e. the
    card's idle share.  ``host_ops=False`` records the card's activity
    alone (for calls of tens of thousands of small ops, whose host-side
    events take the profiler tens of seconds to read back).  Returns the
    share (None if no device time was recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1e3
    idle = 1.0 - busy / wall if busy > 0 else None
    share = (f"idle share {idle:.3f}" if busy > 0
             else "idle share not measured (no device events recorded)")
    top = sorted(events, key=lambda e: -e.device_time_total)[:3]
    print(f"    {label}: profiled call {wall:.2f} ms (host clock), "
          f"device busy {busy:.2f} ms, {share}; largest: "
          + ", ".join(f"{e.key[:32]} x{e.count} "
                      f"{e.device_time_total / 1e3:.2f} ms" for e in top))
    return idle


def card_tokens(torch, seed, vocab, B, S):
    """numpy-seeded (B, S) token ids on the card."""
    a = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return torch.from_numpy(a.astype(np.int32)).cuda()


def card_batch(torch, seed, vocab, B, S):
    """numpy-seeded tokens and their next tokens as labels, (B, S) each,
    on the card."""
    t = card_tokens(torch, seed, vocab, B, S + 1)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def logits_agree(torch, got, want):
    """(agree, max |got - want|, max |want|): within LOGIT_REL x max
    |want|, finite, the same argmax."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ok = (bool(torch.isfinite(got).all()) and err <= LOGIT_REL * scale
          and torch.equal(got.argmax(-1), want.argmax(-1)))
    return ok, err, scale


def compare_logits(torch, label, got, want):
    ok, err, scale = logits_agree(torch, got, want)
    check(bool(torch.isfinite(got).all()), f"{label}: logits not finite")
    check(ok, f"{label}: logits differ by {err} (bound {LOGIT_REL} x "
              f"{scale}) or their argmax differs")
    print(f"  {label}: max |logit diff| {err:.3g} (bound {LOGIT_REL:g} x "
          f"max |logit| {scale:.4g}); argmax equal")


@contextlib.contextmanager
def swapped(module, name, value):
    """``module.name`` is ``value`` inside the block (for comparison
    runs: the plain attention, the plain MoE, a recorded routing)."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def recording(store):
    """``moe.route`` that appends each routing it makes to ``store``."""
    from repro_torch.models import moe
    real = moe.route

    def spy(p, h, c):
        store.append(real(p, h, c))
        return store[-1]
    return spy


def injecting(store):
    """``moe.route`` on the experts of the routings in ``store``, in
    turn, with the router softmax, gates and aux of this run's own
    (``moe.choose``): the plain run held on the K7 run's choices."""
    from repro_torch.models import moe
    real, it = moe.route, iter(store)
    return lambda p, h, c: moe.choose(real(p, h, c).probs, next(it).idx, c)


def launches_of(torch, counts, fn):
    """``fn()`` and the launches it made (``counts`` read before and
    after, the card synchronised)."""
    before = dict(counts)
    res = fn()
    torch.cuda.synchronize()
    return res, _delta(before, counts)


def cuda_events(torch, fn):
    """``fn()`` and its ms (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    end.synchronize()
    return res, start.elapsed_time(end)


def leaf_rels(got, want):
    """Each leaf's max |got - want| relative to its max |want|, in the
    trees' leaf order."""
    from repro_torch.core import pytree as pt
    return [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(pt.leaves(got), pt.leaves(want))]


def worst_rel(got, want):
    """The worst leaf's max |got - want| relative to its max |want|."""
    return max(leaf_rels(got, want))


def leaf_names(tree):
    """The '/'-joined keys of each leaf of ``tree``, in its leaf order
    (dicts by sorted key, as ``pytree.flatten`` walks them)."""
    if isinstance(tree, dict):
        return [f"{k}/{n}" if n else str(k) for k in sorted(tree)
                for n in leaf_names(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [f"{i}/{n}" if n else str(i) for i, t in enumerate(tree)
                for n in leaf_names(t)]
    return [] if tree is None else [""]


def same_bits(a, b):
    from repro_torch.core import pytree as pt
    return all(x.equal(y) for x, y in zip(pt.leaves(a), pt.leaves(b)))


def card_peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2 ** 30


def card_generator(torch, seed: int):
    return torch.Generator(device="cuda").manual_seed(seed)


def init_on_card(torch, specs, seed: int):
    """``init_params`` of ``specs`` drawn on the card from a seeded CUDA
    generator (the same initialisers and scales): the host draws ~124 M
    values a second, ~50 s for qwen3-moe's 6.1 B."""
    from repro_torch.models import init_params
    return init_params(specs, card_generator(torch, seed))


def lm_phase(torch, counts):
    """Phase 10: the LM stack's prefill and serve paths at full width;
    returns its timings (ms) and idle share."""
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import (attention, init_params, model_specs,
                                    param_count)

    out = {}

    def k7_launches(fn):
        """``fn()`` and the K7 launches it made."""
        before = counts["flash_attention"]
        res = fn()
        torch.cuda.synchronize()
        return res, counts["flash_attention"] - before

    def plain_on_card(fn):
        """``fn()`` with the prefill's attention swapped for the plain
        versions (on the card, for comparison only)."""
        with swapped(attention, "attention", attention.plain_attention):
            return fn()

    def prefill_case(cfg, params, B, S, what, against_cpu=None):
        step = make_prefill_step(cfg)
        toks = card_tokens(torch, B * S, cfg.vocab_size, B, S)
        logits, n = k7_launches(lambda: step(params, {"tokens": toks}))
        check(logits.shape == (B, 1, cfg.vocab_size), f"{what}: shape "
                                                        f"{logits.shape}")
        check(n == cfg.num_layers, f"{what}: K7 launched {n} times in one "
                                   f"prefill, not {cfg.num_layers}")
        if against_cpu is not None:
            want = step(against_cpu, {"tokens": toks.cpu()})
            compare_logits(torch, f"{what} B={B} S={S}, card (K7) vs CPU "
                                  f"path", logits, want)
            return
        want = plain_on_card(lambda: step(params, {"tokens": toks}))
        compare_logits(torch, f"{what} B={B} S={S}, K7 vs plain attention "
                              f"on the card", logits, want)
        ms = cuda_ms(torch, lambda: step(params, {"tokens": toks}), 1,
                     repeats=3)
        plain = cuda_ms(torch, lambda: plain_on_card(
            lambda: step(params, {"tokens": toks})), 1, repeats=3)
        out[f"{what} B={B} S={S}"] = ms
        out[f"{what} B={B} S={S} plain attention"] = plain
        print(f"    {ms:.2f} ms per prefill ({B * S / ms * 1e3:.0f} prompt "
              f"tokens/s); with the plain attention {plain:.2f} ms")
        return toks

    t0 = time.perf_counter()
    cfg = get_arch("qwen1.5-0.5b")
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0))
    params_cpu = pt.tmap(lambda x: x.cpu(), params)
    print(f"  qwen1.5-0.5b full config: {param_count(model_specs(cfg)):,} "
          f"params (f32), seed 0, made in {time.perf_counter() - t0:.1f} s")
    prefill_case(cfg, params, 2, 128, "qwen1.5-0.5b", against_cpu=params_cpu)
    prefill_case(cfg, params, 2, 1024, "qwen1.5-0.5b")
    toks = prefill_case(cfg, params, 1, 4096, "qwen1.5-0.5b")
    step = make_prefill_step(cfg)
    out["idle share, qwen B=1 S=4096 prefill"] = device_share(
        torch, lambda: step(params, {"tokens": toks}),
        "qwen1.5-0.5b B=1 S=4096 prefill")

    prompt = card_tokens(torch, 16, cfg.vocab_size, 2, 16)
    before = dict(counts)
    gen = serve.generate(params, cfg, prompt, 16, 128)
    check(_delta(before, counts) == {}, "the decode path launched a kernel")
    gen_cpu = serve.generate(params_cpu, cfg, prompt.cpu(), 16, 128)
    check(torch.equal(gen.tokens.cpu(), gen_cpu.tokens),
          f"serve: greedy tokens differ from the CPU path: "
          f"{gen.tokens.tolist()} vs {gen_cpu.tokens.tolist()}")
    out["serve ms per decode step (B=2)"] = gen.decode_s / 16 * 1e3
    out["serve ms per prompt step (B=2)"] = gen.prompt_s / 16 * 1e3
    print(f"  serve.generate, qwen1.5-0.5b full config, B=2, 16-token "
          f"prompt, 16 new tokens, cache 128: greedy tokens equal the CPU "
          f"path's; {out['serve ms per decode step (B=2)']:.2f} ms per "
          f"decode step, {out['serve ms per prompt step (B=2)']:.2f} ms per "
          f"prompt step (host clock); tokens {gen.tokens.tolist()}")
    del params, params_cpu

    t0 = time.perf_counter()
    ycfg = dataclasses.replace(get_arch("yi-9b"), num_layers=4)
    yparams = init_params(model_specs(ycfg), torch.Generator().manual_seed(0))
    print(f"  yi-9b at full width, 4 of 48 layers: "
          f"{param_count(model_specs(ycfg)):,} params (f32), made in "
          f"{time.perf_counter() - t0:.1f} s")
    prefill_case(ycfg, yparams, 1, 2048, "yi-9b (4 layers)")
    del yparams
    torch.cuda.empty_cache()
    out.update(moe_cells(torch, counts))
    return out


def moe_cells(torch, counts):
    """Phase 10's MoE cells: qwen3-moe-235b-a22b at full width, MOE_LAYERS
    of its 94 layers, random weights drawn on the card from seed 0, f32:
    (a) one ``moe_ffn`` against the per-expert plain version, (b) ties
    against the CPU path, (c) prefill through K7 against the plain
    attention, (d) ``serve.generate`` against the plain MoE; returns
    their timings (ms) and the prefill's idle share."""
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention, model_specs, moe, param_count

    out = {}
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b"),
                              num_layers=MOE_LAYERS)
    mcfg, name = cfg.moe, f"qwen3-moe ({MOE_LAYERS} layers)"
    E, K = mcfg.num_experts, mcfg.top_k
    t0 = time.perf_counter()
    params = init_on_card(torch, model_specs(cfg), 0)
    torch.cuda.synchronize()
    print(f"  qwen3-moe-235b-a22b at full width, {MOE_LAYERS} of 94 layers "
          f"(E={E}, top-{K}, expert d_ff {cfg.d_ff}): "
          f"{param_count(model_specs(cfg)):,} params (f32), drawn on the "
          f"card in {time.perf_counter() - t0:.2f} s")

    # (a) one layer's MoE at B=1, S=4096 against the per-expert version
    layer = pt.tmap(lambda a: a[0], params["stack"]["pos_0"]["moe"])
    S = MOE_TRAIN_S
    gen = card_generator(torch, 1)
    x = torch.randn(1, S, cfg.d_model, generator=gen, device=gen.device)
    Cb = moe.group_capacity(S, mcfg)
    got, aux = moe.moe_ffn(layer, x, mcfg)
    want, aux_plain = moe.moe_ffn_plain(layer, x, mcfg)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "moe_ffn: output not finite")
    check(err <= MOE_REL * scale, f"moe_ffn: differs from the per-expert "
                                  f"version by {err} > {MOE_REL} x {scale}")
    aux_err = abs(float(aux) - float(aux_plain))
    check(aux_err <= MOE_AUX_TOL, f"moe_ffn: aux differs by {aux_err}")
    r = moe.route(layer, x, mcfg)
    dropped = int((moe.slots(r.idx, E, Cb) == E * Cb).sum())
    load = torch.bincount(r.idx.reshape(-1), minlength=E)
    out[f"{name} moe_ffn B=1 S={S}"] = cuda_ms(
        torch, lambda: moe.moe_ffn(layer, x, mcfg), 1, repeats=3)
    out[f"{name} moe_ffn B=1 S={S} plain"] = cuda_ms(
        torch, lambda: moe.moe_ffn_plain(layer, x, mcfg), 1, repeats=3)
    print(f"  (a) moe_ffn, one layer, B=1 S={S}: max |diff| {err:.3g} "
          f"against the per-expert version (bound {MOE_REL:g} x max |out| "
          f"{scale:.4g}), aux {float(aux):.7f} (diff {aux_err:.2g}); "
          f"{dropped} of {S * K} pairs dropped; busiest expert "
          f"{int(load.max())} pairs against Cb={Cb} (mean "
          f"{S * K // E}); {out[f'{name} moe_ffn B=1 S={S}']:.2f} ms, "
          f"per-expert {out[f'{name} moe_ffn B=1 S={S} plain']:.2f} ms")
    del got, want, x, r

    # (b) ties: a zero router and duplicated columns, card vs CPU path
    for router in ("zero", "duplicated"):
        rng = np.random.default_rng(5)
        B, S = 2, 1024
        xt = torch.from_numpy(rng.integers(-1, 2, (B, S, cfg.d_model))
                              .astype(np.float32))
        # router logits in multiples of 2^-10, exact in f32 on both
        # devices: a tie is a tie on the card and on the CPU
        rt = torch.zeros(cfg.d_model, E)
        if router == "duplicated":
            rt[:, 0::2] = torch.from_numpy(
                rng.integers(-1, 2, (cfg.d_model, E // 2)) / 1024).float()
            rt[:, 1::2] = rt[:, 0::2]
        Cb = moe.group_capacity(S, mcfg)
        on_card = moe.route({"router": rt.cuda()}, xt.cuda(), mcfg)
        on_cpu = moe.route({"router": rt}, xt, mcfg)
        slots_card = moe.slots(on_card.idx, E, Cb).cpu()
        slots_cpu = moe.slots(on_cpu.idx, E, Cb)
        check(torch.equal(on_card.idx.cpu(), on_cpu.idx),
              f"ties ({router} router): the card's experts differ from the "
              f"CPU path's")
        check(torch.equal(slots_card, slots_cpu),
              f"ties ({router} router): the card's slots differ from the "
              f"CPU path's")
        if router == "zero":
            check(bool((on_cpu.idx == torch.arange(K)).all()),
                  "ties (zero router): not experts 0..7, lower first")
        print(f"  (b) ties, {router} router, B={B} S={S}: experts, order "
              f"and slots equal the CPU path's; "
              f"{int((slots_cpu == E * Cb).sum())} of {B * S * K} pairs "
              f"dropped on both")

    # (c) prefill through K7 against the plain attention on the card
    step = make_prefill_step(cfg)

    def plain(fn, route=None):
        with swapped(attention, "attention", attention.plain_attention), \
                swapped(moe, "route", route or moe.route):
            return fn()

    for B, S in ((1, 4096), (2, 1024)):
        toks = card_tokens(torch, B * S + 7, cfg.vocab_size, B, S)
        batch = {"tokens": toks}
        k7_routes, plain_routes = [], []
        before = counts["flash_attention"]
        with swapped(moe, "route", recording(k7_routes)):
            logits = step(params, batch)
        torch.cuda.synchronize()
        n = counts["flash_attention"] - before
        check(logits.shape == (B, 1, cfg.vocab_size),
              f"{name}: shape {tuple(logits.shape)}")
        check(n == cfg.num_layers, f"{name}: K7 launched {n} times in one "
                                   f"prefill, not {cfg.num_layers}")
        want = plain(lambda: step(params, batch), recording(plain_routes))
        flips = sum(int((a.idx != b.idx).sum())
                    for a, b in zip(k7_routes, plain_routes))
        # tokens of a layer whose set of experts differs (not the order)
        moved = sum(int((a.idx.sort(-1)[0] != b.idx.sort(-1)[0]).any(-1)
                        .sum()) for a, b in zip(k7_routes, plain_routes))
        label = f"{name} B={B} S={S}, K7 vs plain attention on the card"
        ok, err, _ = logits_agree(torch, logits, want)
        if flips and not ok:
            # a flipped near-tie between the 8th and 9th expert, not K7:
            # hold the case on the K7 run's expert choices
            print(f"  {name} B={B} S={S}: without the K7 run's choices, "
                  f"max |logit diff| {err:.3g}")
            want = plain(lambda: step(params, batch), injecting(k7_routes))
            label += ", the K7 run's expert choices injected"
        compare_logits(torch, label, logits, want)
        print(f"    routing choices that differ between the two runs: "
              f"{flips} of {B * S * K * cfg.num_layers}; (token, layer) "
              f"pairs whose experts differ: {moved} of "
              f"{B * S * cfg.num_layers}")
        ms = cuda_ms(torch, lambda: step(params, batch), 1, repeats=3)
        plain_ms = cuda_ms(torch, lambda: plain(lambda: step(params, batch)),
                           1, repeats=3)
        out[f"{name} B={B} S={S}"] = ms
        out[f"{name} B={B} S={S} plain attention"] = plain_ms
        print(f"    {ms:.2f} ms per prefill ({B * S / ms * 1e3:.0f} prompt "
              f"tokens/s); with the plain attention {plain_ms:.2f} ms")
        if S == 4096:
            out[f"idle share, {name} B=1 S=4096 prefill"] = device_share(
                torch, lambda: step(params, batch),
                f"{name} B=1 S=4096 prefill")
        del logits, want, k7_routes, plain_routes

    # (d) serve: greedy tokens against the same generation on the plain MoE
    prompt = card_tokens(torch, 16, cfg.vocab_size, 2, 16)
    before = dict(counts)
    gen = serve.generate(params, cfg, prompt, 16, 128)
    check(_delta(before, counts) == {}, f"{name}: the decode path launched "
                                        f"a kernel")
    with swapped(moe, "moe_ffn", moe.moe_ffn_plain):
        gen_plain = serve.generate(params, cfg, prompt, 16, 128)
    check(torch.equal(gen.tokens, gen_plain.tokens),
          f"{name} serve: greedy tokens differ from the plain MoE's: "
          f"{gen.tokens.tolist()} vs {gen_plain.tokens.tolist()}")
    out[f"{name} serve ms per decode step (B=2)"] = gen.decode_s / 16 * 1e3
    out[f"{name} serve ms per prompt step (B=2)"] = gen.prompt_s / 16 * 1e3
    print(f"  (d) serve.generate, B=2, 16-token prompt, 16 new tokens, "
          f"cache 128: greedy tokens equal the plain MoE's; "
          f"{out[f'{name} serve ms per decode step (B=2)']:.2f} ms per "
          f"decode step, {out[f'{name} serve ms per prompt step (B=2)']:.2f}"
          f" ms per prompt step (host clock; the plain MoE "
          f"{gen_plain.decode_s / 16 * 1e3:.2f}); tokens "
          f"{gen.tokens.tolist()}")
    del params
    torch.cuda.empty_cache()
    return out


def jamba_phase(torch, counts):
    """Phase 10c: jamba-v0.1-52b at full width, JAMBA_LAYERS of its 32
    layers (7 mamba blocks, 4 with the MoE FFN, and 1 attention block),
    random weights drawn on the card from seed 0, f32: (a) one mamba
    layer's ``mamba_mixer`` through K8 against the plain scan on the
    card, (b) prefill through K7 and K8 against the plain attention and
    the plain scan, (c) ``serve.generate``, its logits after the prompt
    against the prefill's; returns their timings (ms) and the prefill's
    idle share."""
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import (attention, model_specs, moe,
                                    param_count, ssm)

    out = {}
    cfg = dataclasses.replace(get_arch("jamba-v0.1-52b"),
                              num_layers=JAMBA_LAYERS)
    name = f"jamba ({JAMBA_LAYERS} layers)"
    kinds = cfg.layer_kinds
    n_attn = sum(k in (cb.ATTN, cb.ATTN_MOE) for k in kinds)
    n_mamba = len(kinds) - n_attn
    t0 = time.perf_counter()
    params = init_on_card(torch, model_specs(cfg), 0)
    torch.cuda.synchronize()
    print(f"  jamba-v0.1-52b at full width, {JAMBA_LAYERS} of 32 layers "
          f"({n_mamba} mamba, {n_attn} attention; E={cfg.moe.num_experts} "
          f"top-{cfg.moe.top_k} in {kinds.count(cb.MAMBA_MOE)}): "
          f"{param_count(model_specs(cfg)):,} params (f32), drawn on the "
          f"card in {time.perf_counter() - t0:.2f} s")

    def plain_scan(fn):
        with swapped(ssm, "selective_scan", ssm.plain_scan):
            return fn()

    # (a) one mamba layer's mixer at B=1, S=4096: K8 against the plain scan
    layer = pt.tmap(lambda a: a[0], params["stack"]["pos_0"]["mamba"])
    S = 4096
    gen = card_generator(torch, 2)
    x = torch.randn(1, S, cfg.d_model, generator=gen, device=gen.device)
    mixer = lambda: ssm.mamba_mixer(layer, x, cfg)
    before = counts["selective_scan"]
    got = mixer()
    torch.cuda.synchronize()
    check(counts["selective_scan"] - before == 1,
          "mamba_mixer: K8 not launched once")
    want = plain_scan(mixer)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "mamba_mixer: not finite")
    check(err <= K8_REL * scale, f"mamba_mixer: K8 differs from the plain "
                                 f"scan by {err} > {K8_REL} x {scale}")
    out[f"{name} mamba_mixer B=1 S={S}"] = cuda_ms(torch, mixer, 1,
                                                   repeats=3)
    out[f"{name} mamba_mixer B=1 S={S} plain scan"] = cuda_ms(
        torch, lambda: plain_scan(mixer), 1, repeats=1)
    print(f"  (a) mamba_mixer, one layer, B=1 S={S}: max |diff| {err:.3g} "
          f"against the plain scan (bound {K8_REL:g} x max |out| "
          f"{scale:.4g}); {out[f'{name} mamba_mixer B=1 S={S}']:.2f} ms, "
          f"plain scan "
          f"{out[f'{name} mamba_mixer B=1 S={S} plain scan']:.2f} ms")
    del got, want, x

    # (b) prefill through K7 and K8 against the plain attention and scan
    step = make_prefill_step(cfg)

    def plain(fn, route=None):
        with swapped(attention, "attention", attention.plain_attention), \
                swapped(ssm, "selective_scan", ssm.plain_scan), \
                swapped(moe, "route", route or moe.route):
            return fn()

    for B, S in ((1, 4096), (2, 1024)):
        toks = card_tokens(torch, B * S + 11, cfg.vocab_size, B, S)
        batch = {"tokens": toks}
        k_routes, plain_routes = [], []
        before = dict(counts)
        with swapped(moe, "route", recording(k_routes)):
            logits = step(params, batch)
        torch.cuda.synchronize()
        grew = _delta(before, counts)
        check(logits.shape == (B, 1, cfg.vocab_size),
              f"{name}: shape {tuple(logits.shape)}")
        check(grew == {"flash_attention": n_attn, "selective_scan": n_mamba},
              f"{name}: one prefill launched {grew}, not K7 {n_attn} and "
              f"K8 {n_mamba} times")
        want = plain(lambda: step(params, batch), recording(plain_routes))
        flips = sum(int((a.idx != b.idx).sum())
                    for a, b in zip(k_routes, plain_routes))
        label = (f"{name} B={B} S={S}, K7 and K8 vs the plain attention "
                 f"and scan on the card")
        ok, err, _ = logits_agree(torch, logits, want)
        if flips and not ok:
            # a flipped near-tie between the 2nd and 3rd expert: hold the
            # case on the kernels' run's expert choices
            print(f"  {name} B={B} S={S}: without the kernels' run's "
                  f"choices, max |logit diff| {err:.3g}")
            want = plain(lambda: step(params, batch), injecting(k_routes))
            label += ", the kernels' run's expert choices injected"
        compare_logits(torch, label, logits, want)
        print(f"    launches a prefill {grew}; routing choices that differ "
              f"between the two runs: {flips} of "
              f"{B * S * cfg.moe.top_k * len(k_routes)}")
        ms = cuda_ms(torch, lambda: step(params, batch), 1, repeats=3)
        plain_ms = cuda_ms(torch, lambda: plain(lambda: step(params, batch)),
                           1, repeats=1)
        out[f"{name} B={B} S={S}"] = ms
        out[f"{name} B={B} S={S} plain attention and scan"] = plain_ms
        print(f"    {ms:.2f} ms per prefill ({B * S / ms * 1e3:.0f} prompt "
              f"tokens/s); with the plain attention and scan {plain_ms:.2f} "
              f"ms")
        if S == 4096:
            out[f"idle share, {name} B=1 S=4096 prefill"] = device_share(
                torch, lambda: step(params, batch),
                f"{name} B=1 S=4096 prefill")
        del logits, want, k_routes, plain_routes

    # (c) serve: the decode path's logits after the prompt (the mamba
    # blocks' state and conv window built one step a token) against the
    # prefill's last position (the K8 scan), then greedy decode
    B, P, new = 2, 16, 16
    prompt = card_tokens(torch, P, cfg.vocab_size, B, P)
    dec_routes, pre_routes = [], []
    before = dict(counts)
    with swapped(moe, "route", recording(dec_routes)):
        gen = serve.generate(params, cfg, prompt, new, 128)
    check(_delta(before, counts) == {}, f"{name}: the decode path launched "
                                        f"a kernel")
    with swapped(moe, "route", recording(pre_routes)):
        want = step(params, {"tokens": prompt})
    n_moe = len(pre_routes)
    Cb = moe.group_capacity(P, cfg.moe)
    dropped = sum(int((moe.slots(r.idx, cfg.moe.num_experts, Cb)
                       == cfg.moe.num_experts * Cb).sum())
                  for r in pre_routes)
    # the decode path routes each prompt token on its own, layer by layer
    flips = sum(int((dec_routes[t * n_moe + j].idx
                     != pre_routes[j].idx[:, t:t + 1]).sum())
                for t in range(P) for j in range(n_moe))
    label = (f"{name} serve B={B}: the logits after a {P}-token prompt, "
             f"decode path vs prefill")
    ok, err, _ = logits_agree(torch, gen.prompt_logits, want)
    if flips and not ok:
        print(f"  {label}: without the prefill's choices, max |logit diff| "
              f"{err:.3g}")
        calls = iter(range(P * n_moe))
        real = moe.route

        def prefill_choices(p, h, c):
            i = next(calls, None)
            r = real(p, h, c)
            if i is None:
                return r
            t, j = divmod(i, n_moe)
            return moe.choose(r.probs, pre_routes[j].idx[:, t:t + 1], c)
        with swapped(moe, "route", prefill_choices):
            gen = serve.generate(params, cfg, prompt, new, 128)
        label += ", the prefill's expert choices injected"
    compare_logits(torch, label, gen.prompt_logits, want)
    out[f"{name} serve ms per decode step (B=2)"] = gen.decode_s / new * 1e3
    out[f"{name} serve ms per prompt step (B=2)"] = gen.prompt_s / P * 1e3
    print(f"  (c) serve.generate, B={B}, {P}-token prompt, {new} new "
          f"tokens, cache 128: routing choices that differ from the "
          f"prefill's {flips} of {B * P * cfg.moe.top_k * n_moe}, pairs the "
          f"prefill dropped {dropped}; "
          f"{out[f'{name} serve ms per decode step (B=2)']:.2f} ms per "
          f"decode step, {out[f'{name} serve ms per prompt step (B=2)']:.2f}"
          f" ms per prompt step (host clock); tokens {gen.tokens.tolist()}")
    check(bool(torch.isfinite(gen.prompt_logits).all()),
          f"{name} serve: logits not finite")
    # (d) free the weights before phase 11
    del params, gen, want
    torch.cuda.empty_cache()
    return out


#: Phase 10d (b): the prefill held against the plain scans' Python loop
#: (~25 s at S=4096), at this prompt.
XLSTM_CMP = (2, 256)
#: Phases 10d (a) and 11d (a): the mixers and their gradients are held to
#: the plain scans (and their autograd) at B=1 and this S, and timed at
#: S=4096 (the plain step loops take ~2-3 s a mixer at S=4096, their
#: autograd ~12-13 s; phase 3's K9, K10, K9-bwd and K10-bwd rows hold the
#: kernels at S=4096).
XLSTM_MIXER_CMP_S = 1024
#: Phase 10d (d): serving at B=2, the prompt and the greedy tokens.
XLSTM_SERVE = (2, 16, 8)


def xlstm_phase(torch, counts):
    """Phase 10d: xlstm-350m at full width and full depth (24 layers,
    12 sLSTM and 12 mLSTM blocks), random weights drawn on the card from
    seed 0, f32: (a) one mLSTM and one sLSTM mixer through K9 and K10
    against the plain scans on the card at B=1 S=XLSTM_MIXER_CMP_S,
    timed at S=4096, (b) the prefill
    against the plain scans at XLSTM_CMP, (c) the prefill timed at B=1
    S=4096 and B=2 S=1024, (d) ``serve.generate`` against the CPU path on
    the same weights; returns the timings (ms) and the idle share."""
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.launch import serve
    from repro_torch.kernels import ref
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import model_specs, param_count, xlstm

    out = {}
    cfg = get_arch("xlstm-350m")
    name = "xlstm-350m"
    layers = cfg.num_layers // len(cfg.pattern)     # of each kind
    t0 = time.perf_counter()
    params = init_on_card(torch, model_specs(cfg), 0)
    torch.cuda.synchronize()
    print(f"  xlstm-350m at full width and depth ({cfg.num_layers} layers: "
          f"{layers} sLSTM, {layers} mLSTM; d={cfg.d_model}, "
          f"H={cfg.num_heads}, dk={xlstm.mlstm_dims(cfg)[1]}, "
          f"dh={cfg.d_model // cfg.num_heads}, V={cfg.vocab_size}): "
          f"{param_count(model_specs(cfg)):,} params (f32), drawn on the "
          f"card in {time.perf_counter() - t0:.2f} s")

    def plain(fn):
        with swapped(xlstm, "mlstm_scan", ref.mlstm_scan_ref), \
                swapped(xlstm, "slstm_scan", ref.slstm_scan_ref):
            return fn()

    # (a) one layer's mixer of each kind at B=1: the kernel against the
    # plain scan at XLSTM_MIXER_CMP_S, then timed at S=4096
    S = 4096
    gen = card_generator(torch, 3)
    x = torch.randn(1, S, cfg.d_model, generator=gen, device=gen.device)
    x_cmp = x[:, :XLSTM_MIXER_CMP_S]
    for kind, pos, kernel in (("mlstm", "pos_1", "mlstm_scan"),
                              ("slstm", "pos_0", "slstm_scan")):
        layer = pt.tmap(lambda a: a[0], params["stack"][pos][kind])
        mix = getattr(xlstm, f"{kind}_mixer")
        mixer = lambda: mix(layer, x, cfg)
        before = counts[kernel]
        got = mix(layer, x_cmp, cfg)
        torch.cuda.synchronize()
        check(counts[kernel] - before == 1,
              f"{kind}_mixer: {kernel} not launched once")
        want = plain(lambda: mix(layer, x_cmp, cfg))
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()), f"{kind}_mixer: not finite")
        check(err <= XLSTM_REL * scale,
              f"{kind}_mixer: the kernel differs from the plain scan by "
              f"{err} > {XLSTM_REL} x {scale}")
        key = f"{name} {kind}_mixer B=1 S={S}"
        out[key] = cuda_ms(torch, mixer, 1, repeats=3)
        print(f"  (a) {kind}_mixer, one layer, B=1 S={XLSTM_MIXER_CMP_S}: "
              f"max |diff| {err:.3g} against the plain scan (bound "
              f"{XLSTM_REL:g} x max |out| {scale:.4g}); at S={S} "
              f"{out[key]:.2f} ms (the plain scan's time: phase 3)")
        del got, want
    del x, x_cmp

    # (b) the 24-layer prefill through K9 and K10 against the plain scans
    step = make_prefill_step(cfg)
    B, S = XLSTM_CMP
    toks = card_tokens(torch, B * S + 13, cfg.vocab_size, B, S)
    before = dict(counts)
    logits = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    grew = _delta(before, counts)
    check(logits.shape == (B, 1, cfg.vocab_size),
          f"{name}: shape {tuple(logits.shape)}")
    check(grew == {"mlstm_scan": layers, "slstm_scan": layers},
          f"{name}: one prefill launched {grew}, not K9 and K10 {layers} "
          f"times each")
    want = plain(lambda: step(params, {"tokens": toks}))
    compare_logits(torch, f"(b) {name} B={B} S={S}, K9 and K10 vs the plain "
                          f"scans on the card", logits, want)
    print(f"    launches a prefill {grew}")
    del logits, want

    # (c) the prefill's time at a long and a batched prompt
    for B, S in ((1, 4096), (2, 1024)):
        toks = card_tokens(torch, B * S + 17, cfg.vocab_size, B, S)
        batch = {"tokens": toks}
        logits = step(params, batch)
        check(bool(torch.isfinite(logits).all()),
              f"{name} B={B} S={S}: logits not finite")
        ms = cuda_ms(torch, lambda: step(params, batch), 1, repeats=3)
        out[f"{name} B={B} S={S}"] = ms
        print(f"  (c) {name} prefill B={B} S={S}: {ms:.2f} ms "
              f"({B * S / ms * 1e3:.0f} prompt tokens/s)")
        if S == 4096:
            out[f"idle share, {name} B=1 S=4096 prefill"] = device_share(
                torch, lambda: step(params, batch),
                f"{name} B=1 S=4096 prefill")
        del logits

    # (d) serve: the decode path (plain PyTorch on every device, m from
    # 0) against the CPU path's on the same weights and prompt
    B, P, new = XLSTM_SERVE
    prompt = card_tokens(torch, P, cfg.vocab_size, B, P)
    before = dict(counts)
    gen = serve.generate(params, cfg, prompt, new, 128)
    check(_delta(before, counts) == {}, f"{name}: the decode path launched "
                                        f"a kernel")
    t0 = time.perf_counter()
    params_cpu = pt.tmap(lambda a: a.cpu(), params)
    gen_cpu = serve.generate(params_cpu, cfg, prompt.cpu(), new, 128)
    cpu_s = time.perf_counter() - t0
    compare_logits(torch, f"(d) {name} serve B={B}: the logits after a "
                          f"{P}-token prompt, card vs CPU path",
                   gen.prompt_logits, gen_cpu.prompt_logits)
    check(torch.equal(gen.tokens.cpu(), gen_cpu.tokens),
          f"{name} serve: greedy tokens differ from the CPU path: "
          f"{gen.tokens.tolist()} vs {gen_cpu.tokens.tolist()}")
    out[f"{name} serve ms per decode step (B={B})"] = \
        gen.decode_s / new * 1e3
    out[f"{name} serve ms per prompt step (B={B})"] = gen.prompt_s / P * 1e3
    print(f"      serve.generate, B={B}, {P}-token prompt, {new} new "
          f"tokens, cache 128: greedy tokens equal the CPU path's (its "
          f"copy and run {cpu_s:.1f} s); "
          f"{out[f'{name} serve ms per decode step (B={B})']:.2f} ms per "
          f"decode step, "
          f"{out[f'{name} serve ms per prompt step (B={B})']:.2f} ms per "
          f"prompt step (host clock); tokens {gen.tokens.tolist()}")
    del params, params_cpu, gen, gen_cpu
    torch.cuda.empty_cache()
    return out


def train_phase(torch, counts):
    """Phase 11: LM training at full width (qwen1.5-0.5b, random weights
    from seed 0, f32): the loss's gradient, the three train steps, the
    federated trainer through ``launch/train.py`` and pods as clients;
    returns its timings (ms), peak bytes and idle share."""
    from torch.func import grad, vmap

    from repro_torch.configs import get_arch
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.data.batching import stack_device_batches
    from repro_torch.kernels import flatpack
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import podfed, steps, train
    from repro_torch.models import (attention, init_params, model_specs,
                                    transformer)

    out = {}
    cfg = get_arch("qwen1.5-0.5b")
    L = cfg.num_layers
    k7 = ("flash_attention", "flash_attention_bwd")

    def tokens(seed, B, S):
        a = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (B, S + 1))
        t = torch.from_numpy(a.astype(np.int32)).cuda()
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    def plain_on_card(fn):
        saved = attention.attention
        attention.attention = attention.plain_attention
        try:
            return fn()
        finally:
            attention.attention = saved

    launches = functools.partial(launches_of, torch, counts)

    def leaf_diff(a, b):
        return max(float((x.float().cpu() - y.float().cpu()).abs().max())
                   for x, y in zip(pt.leaves(a), pt.leaves(b)))

    peak_gib = functools.partial(card_peak_gib, torch)

    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0))

    # (a) the loss and its gradient against the CPU path
    b = tokens(65, 1, 64)
    lf = lambda p, b: transformer.loss_fn(p, b, cfg, remat="none")  # noqa
    (loss, g), n = launches(lambda: steps.value_and_grad(
        lambda p: lf(p, b), params))
    check(n.get("flash_attention") == L and n.get("flash_attention_bwd") == L,
          f"(a) loss grad: K7 launches {n}, not {L} and {L}")
    params_cpu = pt.tmap(lambda x: x.cpu(), params)
    loss_c, g_c = steps.value_and_grad(
        lambda p: lf(p, pt.tmap(lambda x: x.cpu(), b)), params_cpu)
    del params_cpu
    rel = abs(float(loss) - float(loss_c)) / abs(float(loss_c))
    check(rel <= LOGIT_REL, f"(a) loss {float(loss)} vs CPU {float(loss_c)}")
    worst = max(float((x.cpu() - y).abs().max()) / float(y.abs().max())
                for x, y in zip(pt.leaves(g), pt.leaves(g_c)))
    check(worst <= GRAD_REL, f"(a) a gradient leaf differs by {worst} x its "
                             f"max |g| > {GRAD_REL}")
    print(f"  (a) qwen loss_fn B=1 S=64: {float(loss):.6f} (CPU path "
          f"{float(loss_c):.6f}, rel {rel:.2e} <= {LOGIT_REL:g}); worst "
          f"gradient leaf {worst:.2e} x its max |g| (<= {GRAD_REL:g}); K7 "
          f"{L} forward + {L} backward launches")
    del g, g_c

    # (b) the train steps at train_4k's S=4096, B=1, remat "full"
    b = tokens(4096, 1, 4096)
    zeros = pt.tmap(torch.zeros_like, params)
    step = steps.make_feddane_round_step(cfg, eta=1e-3, mu=0.01,
                                         remat="full")

    def three_steps(record):
        st, losses = {"params": params, "anchor": params, "g_t": zeros}, []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (st, m), n = launches(lambda: step(st, b))
            end.record()
            end.synchronize()
            losses.append(float(m["loss"]))
            record.append((start.elapsed_time(end), n))
        return st, losses

    torch.cuda.reset_peak_memory_stats()
    rec = []
    st, losses = three_steps(rec)
    peak = peak_gib()
    # two gradients a step, each a forward, its recomputation and a backward
    for ms, n in rec:
        check(n.get("flash_attention") == 4 * L
              and n.get("flash_attention_bwd") == 2 * L,
              f"(b) a feddane step launched K7 {n}, not {4 * L} forward "
              f"and {2 * L} backward")
    check(losses[-1] < losses[0], f"(b) the loss did not fall: {losses}")
    rec_plain = []
    st_plain, losses_plain = plain_on_card(lambda: three_steps(rec_plain))
    diff = leaf_diff(st["params"], st_plain["params"])
    moved = leaf_diff(st["params"], params)
    check(diff <= TRAIN_STEP_TOL and moved >= 10 * TRAIN_STEP_TOL,
          f"(b) params K7 vs plain attention differ by {diff} (moved "
          f"{moved}); limit {TRAIN_STEP_TOL}")
    out["train_4k feddane ms a step"] = [r[0] for r in rec]
    out["train_4k feddane, plain attention, ms a step"] = [
        r[0] for r in rec_plain]
    out["train_4k feddane peak GiB"] = peak
    print(f"  (b) make_feddane_round_step train_4k B=1 S=4096 remat=full: "
          f"losses {losses} (plain attention {losses_plain}); ms a step "
          f"{[round(r[0], 2) for r in rec]} (plain attention "
          f"{[round(r[0], 2) for r in rec_plain]}); card peak {peak:.2f} "
          f"GiB; K7 "
          f"{4 * L} forward (a forward and its recomputation per gradient) "
          f"+ {2 * L} backward launches a step; params vs plain attention "
          f"{diff:.2e} (<= {TRAIN_STEP_TOL:g}; the steps moved them "
          f"{moved:.2e})")
    del st_plain
    for name in ("fedavg", "feddane_pipelined"):
        stp = steps.STEP_BUILDERS[name](cfg, eta=1e-3, remat="full")
        state = ({"params": st["params"]} if name == "fedavg" else st)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        (new, m), n = launches(lambda: stp(state, b))
        end.record()
        end.synchronize()
        check(np.isfinite(float(m["loss"])) and n.get("flash_attention") ==
              2 * L and n.get("flash_attention_bwd") == L,
              f"(b) {name}: loss {float(m['loss'])}, K7 launches {n}")
        out[f"train_4k {name} ms a step"] = start.elapsed_time(end)
        print(f"      {name}: one step {start.elapsed_time(end):.2f} ms, loss "
              f"{float(m['loss']):.5f}, K7 {2 * L} + {L} launches")
        del new
    del st, state, zeros
    torch.cuda.empty_cache()

    # (c) the federated trainer through launch/train.py's main path
    argv = ["--full-size", "--num-devices", "8", "--devices-per-round",
            str(LM_TRAIN_K), "--local-epochs", "1", "--batch-size", "4",
            "--seq-len", "64", "--samples-per-device", "16", "--seed", "0"]
    step_counts, first_round, drawn = [], [], []
    orig_step, orig_init = kops.FlatUpdate.step, kops.FlatUpdate.__init__
    orig_round, orig_sample = (FederatedTrainer.round,
                               FederatedTrainer._sample)

    def spy_init(self, *a, **kw):
        step_counts.append([dict(counts)])
        return orig_init(self, *a, **kw)

    def spy_step(self, *a, **kw):
        step_counts[-1].append(dict(counts))
        return orig_step(self, *a, **kw)

    def spy_round(self, st):
        new = orig_round(self, st)
        if not first_round:
            first_round.append(pt.tmap(torch.clone, new.params))
        return new

    def spy_sample(self):
        sel = orig_sample(self)
        drawn.append(np.asarray(sel).tolist())
        return sel

    def run(extra, spy=False):
        if spy:
            kops.FlatUpdate.step, kops.FlatUpdate.__init__ = spy_step, \
                spy_init
            FederatedTrainer.round = spy_round
        FederatedTrainer._sample = spy_sample
        try:
            return train.main(argv + extra)
        finally:
            kops.FlatUpdate.step, kops.FlatUpdate.__init__ = orig_step, \
                orig_init
            FederatedTrainer.round, FederatedTrainer._sample = \
                orig_round, orig_sample

    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (res, n) = launches(lambda: run(["--rounds", "2"], spy=True))
    peak = peak_gib()
    sel_auto, drawn[:] = list(drawn), []
    local_steps = sum(len(c) - 1 for c in step_counts)
    check(n.get("dane_update_flat") == local_steps == 2 * 4,
          f"(c) auto: {n.get('dane_update_flat')} K1 launches in "
          f"{local_steps} local steps (2 rounds of E=1 x nb=4)")
    for solve in step_counts:
        for a, c in zip(solve, solve[1:]):
            d = _delta(a, c)
            check(d.get("flash_attention") == L
                  and d.get("flash_attention_bwd") == L,
                  f"(c) a local step of K={LM_TRAIN_K} launched K7 {d}, "
                  f"not {L} forward and {L} backward")
    out["trainer ms/round"] = res.round_ms
    out["trainer peak GiB"] = peak
    print(f"  (c) train.main --full-size, feddane N=8 K={LM_TRAIN_K} E=1 B=4 "
          f"S=64, 2 rounds on auto: losses {res.losses}; ms/round "
          f"{[round(x, 1) for x in res.round_ms]} (CUDA events); card peak "
          f"{peak:.2f} GiB; {local_steps} local steps, each K1 once and K7 "
          f"{L} forward + {L} backward for all {LM_TRAIN_K} clients; round "
          f"launches {n}")
    auto_params, auto_losses = res.state.params, res.losses
    res_plain = plain_on_card(lambda: run(["--rounds", "2"]))
    out["trainer ms/round, plain attention"] = res_plain.round_ms
    check(drawn == sel_auto, f"(c) selections differ with the plain "
                             f"attention: {drawn} vs {sel_auto}")
    diff = leaf_diff(auto_params, res_plain.state.params)
    del res_plain
    flat_first = first_round[0]
    drawn[:] = []
    (res_leaf, n) = launches(lambda: run(["--rounds", "1", "--local-solver",
                                          "per_leaf"]))
    check(drawn == sel_auto[:len(drawn)], "(c) per_leaf selections differ")
    check(all(torch.equal(x, y) for x, y in zip(
        pt.leaves(res_leaf.state.params), pt.leaves(flat_first))),
        "(c) per_leaf's round differs from flat's")
    check(n.get("dane_update_2d") == 4 and not n.get("dane_update_flat"),
          f"(c) per_leaf launched {n}, not K4 once a local step")
    moved = leaf_diff(auto_params, flat_first)
    check(diff <= TRAJECTORY_TOL and moved >= 10 * TRAJECTORY_TOL,
          f"(c) params K7 vs plain attention differ by {diff} (the second "
          f"round moved them {moved}); limit {TRAJECTORY_TOL}")
    out["trainer ms/round, per_leaf"] = res_leaf.round_ms
    print(f"      plain attention on the card: the same selections "
          f"{sel_auto}, params within {diff:.2e} (<= {TRAJECTORY_TOL:g}; "
          f"round 2 moved them {moved:.2e}), ms/round "
          f"{[round(x, 1) for x in out['trainer ms/round, plain attention']]}"
          f"; per_leaf 1 round bitwise equal to flat's, K4 "
          f"{n.get('dane_update_2d')} launches ({res_leaf.round_ms[0]:.1f} "
          f"ms)")
    trainer = res_leaf.trainer
    p0 = res_leaf.state.params
    del res, res_leaf, auto_params, flat_first, first_round[:]
    torch.cuda.empty_cache()

    # the idle share of one local step: K clients' vmap(grad) and K1
    batches, _ = stack_device_batches(trainer.dataset,
                                      np.array(sel_auto[0][:LM_TRAIN_K]))
    batch = pt.tmap(lambda x: x[:, 0], batches)
    w = pt.tmap(lambda x: x.expand((LM_TRAIN_K,) + x.shape).contiguous(), p0)
    upd = kops.FlatUpdate(flatpack.flat_spec(p0), pt.tmap(torch.zeros_like, w),
                          p0, LM_TRAIN_K)
    grad_fn = vmap(grad(train.make_lm_loss(cfg)))
    on = torch.ones(LM_TRAIN_K, device=pt.leaves(p0)[0].device)
    one_step = lambda: upd.step(grad_fn(w, batch), 0.05, 0.01, on)  # noqa
    one_step()
    out["idle share, trainer local step"] = device_share(
        torch, one_step, f"qwen trainer local step (K={LM_TRAIN_K})")
    del w, upd, batches, batch, trainer, p0
    torch.cuda.empty_cache()

    # (d) pods as clients
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0))

    def pods(n):
        return pt.tmap(lambda x: x.unsqueeze(0).expand((n,) + x.shape)
                       .contiguous(), params)

    b = tokens(7, 1, 64)
    fn, _ = podfed.make_podfed_round_step(cfg, local_steps=1, eta=1e-2,
                                          mu=0.01, remat="none")
    one = pods(1)
    new, m = fn({"params": one, "anchor": one,
                 "g_t": pt.tmap(torch.zeros_like, one)},
                {k: v[None, None] for k, v in b.items()})
    g_anchor = steps.value_and_grad(lambda p: lf(p, b), params)[1]
    want, _ = steps.make_feddane_round_step(cfg, eta=1e-2, mu=0.01,
                                            remat="none")(
        {"params": params, "anchor": params, "g_t": g_anchor}, b)
    diff = max(float((x[0] - y).abs().max()) for x, y in zip(
        pt.leaves(new["params"]), pt.leaves(want["params"])))
    check(diff <= POD_TOL, f"(d) one pod, E=1 vs the feddane step: {diff}")
    del new, want, g_anchor, one
    two = pods(2)
    bb = {k: torch.stack([v, torch.roll(v, 1, dims=1)])[:, None].expand(
        2, 2, *v.shape).contiguous() for k, v in b.items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn2, _ = podfed.make_podfed_round_step(cfg, local_steps=2, eta=1e-2,
                                           mu=0.01, remat="full")
    (new, m), n = launches(lambda: fn2(
        {"params": two, "anchor": two,
         "g_t": pt.tmap(torch.zeros_like, two)}, bb))
    end.record()
    end.synchronize()
    finite = all(bool(torch.isfinite(x).all()) for x in pt.leaves(new))
    check(finite and np.isfinite(float(m["loss"])),
          "(d) 2 pods x 2 steps: not finite")
    out["podfed 2 pods x 2 steps ms"] = start.elapsed_time(end)
    print(f"  (d) podfed: one pod, E=1 against make_feddane_round_step "
          f"{diff:.2e} (<= {POD_TOL:g}); 2 pods x 2 local steps, 1 round: "
          f"finite, loss {float(m['loss']):.5f}, "
          f"{start.elapsed_time(end):.1f} ms, launches {n}")
    del new, two, params
    torch.cuda.empty_cache()
    return out


def train_drawn(argv, nudge: float = 0.0, relative: bool = False):
    """``launch/train.py``'s ``main`` on ``argv``, its selections
    recorded: (its result, the selections), its prints swallowed.
    ``nudge``: the drawn weights moved by ``nudge`` x N(0, 1) (seed 7),
    times each weight where ``relative`` (zeros stay zeros)."""
    import io

    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.launch import train

    drawn, orig = [], FederatedTrainer._sample
    orig_init = train.init_params

    def spy(self):
        sel = orig(self)
        drawn.append(np.asarray(sel).tolist())
        return sel

    def nudged(specs, gen, device=None):
        import torch
        g = torch.Generator().manual_seed(7)
        return pt.tmap(lambda t: t + nudge * torch.randn(
            t.shape, generator=g).to(t.device) * (t if relative else 1),
            orig_init(specs, gen, device=device))

    FederatedTrainer._sample = spy
    if nudge:
        train.init_params = nudged
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            return train.main(argv), drawn
    finally:
        FederatedTrainer._sample = orig
        train.init_params = orig_init


def _pooled_train(argv, nudge: float = 0.0, relative: bool = False):
    res, drawn = train_drawn(argv, nudge, relative)
    return res.state.params, drawn, res.losses


def moe_train_phase(torch, counts, pool):
    """Phase 11b: training the MoE archs.  qwen3-moe-235b-a22b at full
    width, MOE_TRAIN_LAYERS of its 94 layers, weights drawn on the card
    from seed 0, f32: (a) one layer's ``moe_ffn`` gradient against
    ``moe_ffn_plain``'s, (b) its ``vmap(grad)`` at the trainer's local
    step against separate gradients, (c) ``loss_fn``'s gradient at B=1
    S=4096 through K7 and K7-bwd against the plain attention, (d) one
    ``make_fedavg_step``; then (e) both MoE archs at ``launch/train.py``'s
    reduced preset: the three train steps, the trainer against the CPU
    path (run in ``pool``) and pods as clients.  Returns timings (ms)
    and peaks (GiB)."""
    import torch._C._functorch as functorch
    from torch.func import grad, vmap

    from repro_torch.configs import get_arch
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.launch import podfed, steps
    from repro_torch.models import (attention, model_specs, moe,
                                    param_count, transformer)

    out = {}
    k7 = ("flash_attention", "flash_attention_bwd")
    argv = ["--num-devices", "8", "--devices-per-round", "2",
            "--local-epochs", "1", "--batch-size", "4", "--seq-len", "64",
            "--samples-per-device", "16", "--seed", "0"]
    archs = ("qwen3-moe-235b-a22b", "arctic-480b")
    # (e)'s CPU path, in the pool while the card runs (a)-(d)
    cpu_runs = {a: pool.submit(_pooled_train, ["--arch", a, "--rounds",
                                               "2", "--device", "cpu"]
                               + argv) for a in archs}

    launches = functools.partial(launches_of, torch, counts)

    events = functools.partial(cuda_events, torch)

    worst, same = worst_rel, same_bits

    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b"),
                              num_layers=MOE_TRAIN_LAYERS)
    mcfg, L = cfg.moe, MOE_TRAIN_LAYERS
    E, K = mcfg.num_experts, mcfg.top_k
    name = f"qwen3-moe ({L} layer)"
    t0 = time.perf_counter()
    params = init_on_card(torch, model_specs(cfg), 0)
    torch.cuda.synchronize()
    n_params = param_count(model_specs(cfg))
    print(f"  qwen3-moe-235b-a22b at full width, {L} of 94 layers: "
          f"{n_params:,} params ({n_params * 4 / 1e9:.2f} GB f32), drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s")

    # (a) one layer's moe_ffn gradient against the per-expert version's
    layer = pt.tmap(lambda a: a[0], params["stack"]["pos_0"]["moe"])
    S = MOE_TRAIN_S
    gen = card_generator(torch, 1)
    x = torch.randn(1, S, cfg.d_model, generator=gen, device=gen.device)
    w = torch.randn(1, S, cfg.d_model, generator=gen, device=gen.device)

    def layer_grad(fn):
        """d/d(x, every weight) of sum(w * out) + aux."""
        xs = [t.detach().requires_grad_(True) for t in [x] + pt.leaves(layer)]
        p = pt.unflatten(pt.flatten(layer)[1], xs[1:])
        o, aux = fn(p, xs[0], mcfg)
        return torch.autograd.grad((o * w).sum() + aux, xs)

    got = layer_grad(moe.moe_ffn)
    again = layer_grad(moe.moe_ffn)
    check(same(got, again), "(a) two moe_ffn gradients differ")
    del again
    want = layer_grad(moe.moe_ffn_plain)
    err = worst(got, want)
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "(a) moe_ffn gradient not finite")
    check(err <= GRAD_REL, f"(a) moe_ffn's gradient differs from the "
                           f"per-expert version's by {err} x max |g|")
    Cb = moe.group_capacity(S, mcfg)
    dropped = int((moe.slots(moe.route(layer, x, mcfg).idx, E, Cb)
                   == E * Cb).sum())
    out[f"{name} moe_ffn grad B=1 S={S} ms"] = cuda_ms(
        torch, lambda: layer_grad(moe.moe_ffn), 1, repeats=3)
    out[f"{name} moe_ffn grad B=1 S={S} plain ms"] = events(
        lambda: layer_grad(moe.moe_ffn_plain))[1]
    print(f"  (a) moe_ffn gradient (x and {len(got) - 1} weights), one "
          f"layer, B=1 S={S}: worst leaf {err:.2e} x its max |g| (<= "
          f"{GRAD_REL:g}) against moe_ffn_plain's; two runs bitwise equal "
          f"(the dispatch gather's scatter-add); {dropped} of {S * K} pairs "
          f"dropped (Cb={Cb}); "
          f"{out[f'{name} moe_ffn grad B=1 S={S} ms']:.2f} ms, per-expert "
          f"{out[f'{name} moe_ffn grad B=1 S={S} plain ms']:.2f} ms "
          f"(CUDA events; median of 3, its second call)")
    del got, want, x, w

    # (b) vmap(grad) over the clients' data at the trainer's local step
    n, B, Sb = MOE_VMAP
    xb = torch.randn(n, B, Sb, cfg.d_model, generator=gen, device=gen.device)
    wb = torch.randn(B, Sb, cfg.d_model, generator=gen, device=gen.device)

    def f(p, x):
        o, aux = moe.moe_ffn(p, x, mcfg)
        return (o * wb).sum() + aux

    was = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        g_v, ms = events(lambda: vmap(grad(f), in_dims=(None, 0))(layer, xb))
    finally:
        functorch._set_vmap_fallback_enabled(was)
    vmap_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bitwise, err, leaf_err, logits = True, 0.0, 0.0, 0.0
    lv = vmap(lambda x: x @ layer["router"])(xb)
    for i in range(n):
        g_i = grad(f)(layer, xb[i])
        mine = pt.index(g_v, i)
        bitwise &= same(mine, g_i)
        g_max = max(float(x.abs().max()) for x in pt.leaves(g_i))
        err = max(err, max(float((a - b).abs().max()) for a, b in zip(
            pt.leaves(mine), pt.leaves(g_i))) / g_max)
        leaf_err = max(leaf_err, worst(mine, g_i))
        logits = max(logits, float((lv[i] - xb[i] @ layer["router"])
                                   .abs().max()))
        del g_i, mine
    check(bitwise or err <= VMAP_REL,
          f"(b) vmap(grad) differs from separate gradients by {err} x max "
          f"|g| > {VMAP_REL}")
    del g_v
    functorch._set_vmap_fallback_enabled(False)
    try:
        ms2 = events(lambda: vmap(grad(f), in_dims=(None, 0))(layer, xb))[1]
    finally:
        functorch._set_vmap_fallback_enabled(was)
    out[f"{name} moe_ffn vmap(grad) {n}x{B}x{Sb} ms"] = [ms, ms2]
    out[f"{name} moe_ffn vmap(grad) peak GiB"] = vmap_peak
    why = (f"within {err:.2e} x the gradient's max |g| of the separate "
           f"gradients (<= {VMAP_REL:g}; the worst leaf {leaf_err:.2e} x "
           f"its own max), not bitwise: the batched router product "
           f"({n * B * Sb} rows against {B * Sb}) takes another cuBLAS "
           f"kernel, whose logits differ by up to {logits:.2e}")
    print(f"  (b) vmap(grad) of that layer, in_dims=(None, 0), {n} clients x "
          f"B={B} x S={Sb} (Cb={moe.group_capacity(Sb, mcfg)}), vmap's "
          f"fallback off: " + ("bitwise equal to the separate gradients"
                               if bitwise else why)
          + f"; {ms:.2f} ms the first call, {ms2:.2f} ms the second (CUDA "
          f"events); card peak {vmap_peak:.2f} GiB (the params and "
          f"{n} clients' weight gradients: no weight copied a client)")
    del lv
    del xb, wb, layer

    # (d) one fedavg step, then (c) the loss's gradient it takes
    b = card_batch(torch, S, cfg.vocab_size, 1, S)
    lf = lambda p: transformer.loss_fn(p, b, cfg, remat="full")  # noqa
    eta = 1e-3
    step = steps.make_fedavg_step(cfg, eta=eta, remat="full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ((new, m), step_ms), n_step = launches(
        lambda: events(lambda: step({"params": params}, b)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    routes, plain_routes = [], []
    with swapped(moe, "route", recording(routes)):
        ((loss, g), g_ms), n_grad = launches(
            lambda: events(lambda: steps.value_and_grad(lf, params)))
    check(n_grad.get("flash_attention") == 2 * L
          and n_grad.get("flash_attention_bwd") == L,
          f"(c) a gradient launched K7 {n_grad}, not {2 * L} forward and "
          f"{L} backward")
    check(torch.equal(m["loss"], loss), f"(d) the fedavg step's loss "
                                        f"{float(m['loss'])} is not (c)'s "
                                        f"{float(loss)}")
    check(all(torch.equal(a, p - g_ * eta) for a, p, g_ in zip(
        pt.leaves(new["params"]), pt.leaves(params), pt.leaves(g))),
        "(d) the fedavg step's params are not params - eta g of (c)'s "
        "gradient")
    check(n_step.get("flash_attention") == 2 * L
          and n_step.get("flash_attention_bwd") == L,
          f"(d) the fedavg step launched K7 {n_step}")
    del new
    (loss2, g2), g2_ms = events(lambda: steps.value_and_grad(lf, params))
    check(torch.equal(loss, loss2) and same(g, g2),
          "(c) two K7 gradients differ")
    del g2
    with swapped(attention, "attention", attention.plain_attention), \
            swapped(moe, "route", recording(plain_routes)):
        (loss_p, g_p), p_ms = events(lambda: steps.value_and_grad(lf, params))
    flips = sum(int((a.idx != c.idx).sum())
                for a, c in zip(routes, plain_routes))
    rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    err = worst(g, g_p)
    held = "the plain run's own choices"
    if flips and (rel > LOGIT_REL or err > GRAD_REL):
        print(f"  (c) on its own choices the plain route's loss is {rel:.2e} "
              f"and the worst gradient leaf {err:.2e} away")
        del g_p
        with swapped(attention, "attention", attention.plain_attention), \
                swapped(moe, "route", injecting(routes)):
            loss_p, g_p = steps.value_and_grad(lf, params)
        rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
        err = worst(g, g_p)
        held = "the K7 run's expert choices injected"
    check(rel <= LOGIT_REL and err <= GRAD_REL,
          f"(c) K7 against the plain attention: loss {rel}, worst gradient "
          f"leaf {err} x its max |g|")
    check(all(bool(torch.isfinite(x).all()) for x in pt.leaves(g)),
          "(c) gradient not finite")
    out[f"{name} loss grad B=1 S={S} ms"] = [g_ms, g2_ms]
    out[f"{name} loss grad B=1 S={S} plain attention ms"] = p_ms
    out[f"{name} fedavg step ms"] = step_ms
    out[f"{name} fedavg step peak GiB"] = peak
    print(f"  (c) loss_fn B=1 S={S} remat=full: {float(loss):.6f}; its "
          f"gradient {g_ms:.2f}, {g2_ms:.2f} ms (CUDA events), two runs "
          f"bitwise equal; K7 {2 * L} forward + {L} backward launches; "
          f"against the plain attention ({p_ms:.2f} ms, {held}): loss rel "
          f"{rel:.2e} (<= {LOGIT_REL:g}), worst leaf {err:.2e} x its max "
          f"|g| (<= {GRAD_REL:g}); routing choices that differ between the "
          f"two runs: {flips} of {sum(r.idx.numel() for r in routes)} (the "
          f"forward and its recomputation)")
    print(f"  (d) make_fedavg_step, B=1 S={S} remat=full: {step_ms:.2f} ms "
          f"(CUDA events); its loss bitwise (c)'s, its params bitwise params "
          f"- eta g of (c)'s gradient; card peak {peak:.2f} GiB (4 x "
          f"{n_params * 4 / 2 ** 30:.2f} GiB of params and gradient buffers "
          f"and the activations)")
    del g, g_p, params, routes, plain_routes
    torch.cuda.empty_cache()

    # (e) both MoE archs at launch/train.py's reduced preset
    for arch in archs:
        rcfg = get_arch(arch).reduced(num_layers=2, d_model=128,
                                      vocab_size=256)
        L = rcfg.num_layers
        rp = init_on_card(torch, model_specs(rcfg), 0)
        rb = card_batch(torch, 65, rcfg.vocab_size, 4, 64)
        zeros = pt.tmap(torch.zeros_like, rp)
        step_n, step_ms = {}, {}
        for algo, build in steps.STEP_BUILDERS.items():
            st = {"params": rp} if algo == "fedavg" else \
                {"params": rp, "anchor": rp, "g_t": zeros}
            ((new, m), step_ms[algo]), grew = launches(
                lambda: events(lambda: build(rcfg, eta=1e-3,
                                             remat="full")(st, rb)))
            grads = 2 if algo == "feddane" else 1
            step_n[algo] = {k: grew.get(k, 0) for k in k7}
            check(np.isfinite(float(m["loss"])) and all(
                bool(torch.isfinite(x).all()) for x in pt.leaves(new))
                and step_n[algo] == {k7[0]: 2 * grads * L,
                                     k7[1]: grads * L},
                f"(e) {arch} {algo} step: loss {float(m['loss'])}, K7 "
                f"launches {grew}")
            out[f"{arch} reduced {algo} step ms"] = step_ms[algo]
        print(f"  (e) {arch} reduced ({param_count(model_specs(rcfg)):,} "
              f"params, {rcfg.moe.num_experts} experts top-"
              f"{rcfg.moe.top_k}, d={rcfg.d_model}, {L} layers), B=4 S=64 "
              f"remat=full, one step each: ms "
              f"{ {a: round(v, 2) for a, v in step_ms.items()} }; K7 "
              f"launches {step_n}")
        del rp, zeros

        first = []
        orig_round = FederatedTrainer.round

        def spy_round(self, st):
            new = orig_round(self, st)
            if not first:
                first.append(pt.tmap(torch.clone, new.params))
            return new

        FederatedTrainer.round = spy_round
        try:
            (res, sel), grew = launches(lambda: train_drawn(
                ["--arch", arch, "--rounds", "2"] + argv))
        finally:
            FederatedTrainer.round = orig_round
        steps_run = 2 * 4
        check(grew.get("dane_update_flat") == steps_run
              and not grew.get("dane_update_2d") and grew.get(k7[0], 0) > 0
              and grew.get(k7[1], 0) > 0,
              f"(e) {arch} trainer auto: {grew} (K1 once a local step, "
              f"{steps_run} steps)")
        (res_leaf, sel_leaf), grew_leaf = launches(lambda: train_drawn(
            ["--arch", arch, "--rounds", "1", "--local-solver", "per_leaf"]
            + argv))
        check(grew_leaf.get("dane_update_2d") == 4
              and not grew_leaf.get("dane_update_flat"),
              f"(e) {arch} per_leaf: {grew_leaf} (K4 once a local step)")
        check(sel_leaf == sel[:len(sel_leaf)]
              and same(res_leaf.state.params, first[0]),
              f"(e) {arch}: per_leaf's round differs from flat's")
        p_cpu, sel_cpu, losses_cpu = cpu_runs[arch].result()
        check(sel == sel_cpu, f"(e) {arch}: selections {sel} on the card, "
                              f"{sel_cpu} on the CPU path")
        diff = max_err(torch, pt.tmap(lambda x: x.cpu(), res.state.params),
                       p_cpu)
        check(diff <= TRAJECTORY_TOL and all(np.isfinite(res.losses)),
              f"(e) {arch}: params {diff} from the CPU path's after 2 "
              f"rounds > {TRAJECTORY_TOL}")
        out[f"{arch} reduced trainer ms/round"] = res.round_ms
        print(f"      train.py feddane N=8 K=2 E=1 B=4 S=64: 2 rounds on auto "
              f"(flat) {[round(x, 1) for x in res.round_ms]} ms/round (CUDA "
              f"events), losses {[round(x, 5) for x in res.losses]} (CPU path "
              f"{[round(x, 5) for x in losses_cpu]}); the CPU path's "
              f"selections {sel_cpu}, params within {diff:.2e} (<= "
              f"{TRAJECTORY_TOL:g}); per_leaf 1 round bitwise equal to "
              f"flat's ({res_leaf.round_ms[0]:.1f} ms); launches flat "
              f"{grew}, per_leaf {grew_leaf}")
        p0 = res.state.params
        del res, res_leaf, first[:]

        def pods(n):
            return pt.tmap(lambda x: x.unsqueeze(0).expand((n,) + x.shape)
                           .contiguous(), p0)

        two = pods(2)
        bb = {k: torch.stack([v, torch.roll(v, 1, dims=1)])[:, None].expand(
            2, 2, *v.shape).contiguous() for k, v in rb.items()}
        fn2, _ = podfed.make_podfed_round_step(rcfg, local_steps=2,
                                               eta=1e-2, mu=0.01,
                                               remat="full")
        ((pnew, pm), pod_ms), grew = launches(lambda: events(lambda: fn2(
            {"params": two, "anchor": two,
             "g_t": pt.tmap(torch.zeros_like, two)}, bb)))
        check(np.isfinite(float(pm["loss"])) and all(
            bool(torch.isfinite(x).all()) for x in pt.leaves(pnew)),
            f"(e) {arch} podfed 2 pods x 2 steps: not finite")
        out[f"{arch} reduced podfed 2 pods x 2 steps ms"] = pod_ms
        print(f"      podfed 2 pods x 2 local steps, 1 round: finite, loss "
              f"{float(pm['loss']):.5f}, {pod_ms:.1f} ms, launches {grew}")
        del two, pnew, p0
    torch.cuda.empty_cache()
    return out


def jamba_cut(layers: int):
    """jamba-v0.1-52b at full width, its first ``layers`` layers (the
    pattern cut to them, one repeat)."""
    from repro_torch.configs import get_arch
    cfg = get_arch("jamba-v0.1-52b")
    return dataclasses.replace(cfg, num_layers=layers,
                               pattern=cfg.pattern[:layers])


#: Phase 11c (f)'s argv of ``launch/train.py`` (the CPU path's run
#: adds ``--device cpu``).
JAMBA_TRAIN_ARGV = ["--arch", "jamba-v0.1-52b", "--layers", "1", "--lr",
                    JAMBA_TRAIN_LR, "--num-devices", "8",
                    "--devices-per-round", "2", "--local-epochs", "1",
                    "--batch-size", "4", "--seq-len", "64",
                    "--samples-per-device", "16", "--seed", "0"]


def jamba_train_phase(torch, counts, cpu_run):
    """Phase 11c: training the hybrid arch.  jamba-v0.1-52b at full
    width, weights drawn on the card from seed 0, f32: (b) one
    ``mamba_mixer``'s gradient through K8 and K8-bwd against the plain
    scan's autograd at B=1 S=JAMBA_MIXER_CMP_S, timed at S=4096; (c) ``loss_fn``'s gradient at JAMBA_TRAIN_LAYERS
    layers, B=1 S=4096, remat="full", against the plain scan route;
    (d) one ``make_fedavg_step``; (e) 3 ``make_feddane_round_step``
    steps at JAMBA_STEP_LAYERS layer against the plain scan's, one
    pipelined step; (f) the reduced preset's ``train.main`` against the
    CPU path (``cpu_run``, a future of the pool), per_leaf, pods.
    ((a), K8-bwd alone, is in phase 3.)  Returns timings (ms) and peaks
    (GiB)."""
    from repro_torch.configs import base as cb
    from repro_torch.configs import get_arch
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.kernels import dane_update
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import podfed, steps
    from repro_torch.models import (model_specs, moe, param_count, ssm,
                                    transformer)

    out = {}
    k8 = ("selective_scan", "selective_scan_bwd")
    S = 4096

    launches = functools.partial(launches_of, torch, counts)

    events = functools.partial(cuda_events, torch)

    worst, same = worst_rel, same_bits

    def plain_scan(fn, route=None):
        with swapped(ssm, "selective_scan", ssm.plain_scan), \
                swapped(moe, "route", route or moe.route):
            return fn()

    peak_gib = functools.partial(card_peak_gib, torch)

    cfg = jamba_cut(JAMBA_TRAIN_LAYERS)
    L = JAMBA_TRAIN_LAYERS
    name = f"jamba ({L} layers)"
    params = init_on_card(torch, model_specs(cfg), 0)
    torch.cuda.synchronize()
    n_params = param_count(model_specs(cfg))
    print(f"  jamba-v0.1-52b at full width, its first {L} of 32 layers "
          f"({', '.join(cfg.layer_kinds)}): {n_params:,} params "
          f"({n_params * 4 / 2 ** 30:.2f} GiB f32), drawn on the card")

    # (b) one mixer's gradient, x and every leaf, K8/K8-bwd vs plain scan
    # at JAMBA_MIXER_CMP_S, then timed at S
    layer = pt.tmap(lambda a: a[0], params["stack"]["pos_0"]["mamba"])
    gen = card_generator(torch, 3)
    x = torch.randn(1, S, cfg.d_model, generator=gen, device=gen.device)
    w = torch.randn(1, S, cfg.d_model, generator=gen, device=gen.device)
    S_cmp = JAMBA_MIXER_CMP_S

    def mixer_grad(s):
        xs = [t.detach().requires_grad_(True)
              for t in [x[:, :s]] + pt.leaves(layer)]
        p = pt.unflatten(pt.flatten(layer)[1], xs[1:])
        return torch.autograd.grad(
            (ssm.mamba_mixer(p, xs[0], cfg) * w[:, :s]).sum(), xs)

    (got, cmp_ms), n = launches(lambda: events(lambda: mixer_grad(S_cmp)))
    check(n == {k8[0]: 1, k8[1]: 1}, f"(b) the mixer's gradient launched "
                                     f"{n}, not K8 and K8-bwd once")
    want, plain_ms = events(lambda: plain_scan(lambda: mixer_grad(S_cmp)))
    err = worst(got, want)
    check(all(bool(torch.isfinite(g).all()) for g in got)
          and err <= GRAD_REL, f"(b) the mixer's gradient differs from the "
                               f"plain scan's by {err} x max |g|")
    del got, want
    (got, ms), n = launches(lambda: events(lambda: mixer_grad(S)))
    check(n == {k8[0]: 1, k8[1]: 1}
          and all(bool(torch.isfinite(g).all()) for g in got),
          f"(b) the mixer's S={S} gradient launched {n}, or is not finite")
    ms = [ms, events(lambda: mixer_grad(S))[1]]
    out[f"jamba mamba_mixer grad B=1 S={S} ms"] = ms
    out[f"jamba mamba_mixer grad B=1 S={S_cmp} ms"] = cmp_ms
    out[f"jamba mamba_mixer grad B=1 S={S_cmp} plain scan ms"] = plain_ms
    print(f"  (b) mamba_mixer's gradient (x and {len(got) - 1} weights), "
          f"B=1 S={S_cmp}: worst leaf {err:.2e} x its max |g| (<= "
          f"{GRAD_REL:g}) against the plain scan's autograd; K8 + K8-bwd "
          f"once; {cmp_ms:.2f} ms, plain scan {plain_ms:.1f} ms; at S={S}: "
          f"{ms[0]:.2f}, {ms[1]:.2f} ms (CUDA events)")
    del got, x, w, layer

    # (d) one fedavg step, then (c) the loss's gradient it takes
    b = card_batch(torch, S + 5, cfg.vocab_size, 1, S)
    lf = lambda p: transformer.loss_fn(p, b, cfg, remat="full")  # noqa
    eta = 1e-3
    n_mamba = sum(k in (cb.MAMBA, cb.MAMBA_MOE) for k in cfg.layer_kinds)
    want_n = {k8[0]: 2 * n_mamba, k8[1]: n_mamba}
    step = steps.make_fedavg_step(cfg, eta=eta, remat="full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the first step at this size, then the one held below
    step_ms = [events(lambda: step({"params": params}, b))[1]]
    ((new, m), ms), n_step = launches(
        lambda: events(lambda: step({"params": params}, b)))
    step_ms.append(ms)
    peak = peak_gib()
    routes, plain_routes = [], []
    with swapped(moe, "route", recording(routes)):
        ((loss, g), g_ms), n_grad = launches(
            lambda: events(lambda: steps.value_and_grad(lf, params)))
    check({k: n_grad.get(k, 0) for k in k8} == want_n,
          f"(c) a gradient launched {n_grad}, not K8 {2 * n_mamba} and "
          f"K8-bwd {n_mamba} times")
    check({k: n_step.get(k, 0) for k in k8} == want_n,
          f"(d) the fedavg step launched {n_step}")
    check(torch.equal(m["loss"], loss), f"(d) the fedavg step's loss "
                                        f"{float(m['loss'])} is not (c)'s "
                                        f"{float(loss)}")
    check(all(torch.equal(a, p - g_ * eta) for a, p, g_ in zip(
        pt.leaves(new["params"]), pt.leaves(params), pt.leaves(g))),
        "(d) the fedavg step's params are not params - eta g of (c)'s "
        "gradient")
    del new
    (loss2, g2), g2_ms = events(lambda: steps.value_and_grad(lf, params))
    check(torch.equal(loss, loss2) and same(g, g2),
          "(c) two K8 gradients differ")
    del g2
    # the plain route without remat (the same values; its scan's Python
    # loop runs one forward, not two): each MoE block routes once, where
    # the K8 run routed in the forward and again in its recomputation
    lf_plain = lambda p: transformer.loss_fn(p, b, cfg,  # noqa
                                             remat="none")
    (loss_p, g_p), p_ms = events(lambda: plain_scan(
        lambda: steps.value_and_grad(lf_plain, params),
        recording(plain_routes)))
    check(len(routes) == 2 * len(plain_routes),
          f"(c) {len(routes)} routings under remat full, "
          f"{len(plain_routes)} without")
    routes = routes[:len(plain_routes)]
    flips = sum(int((a.idx != c.idx).sum())
                for a, c in zip(routes, plain_routes))
    rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    err = worst(g, g_p)
    held = "the plain run's own choices"
    if flips and (rel > LOGIT_REL or err > GRAD_REL):
        print(f"  (c) on its own choices the plain route's loss is {rel:.2e} "
              f"and the worst gradient leaf {err:.2e} away")
        del g_p
        loss_p, g_p = plain_scan(
            lambda: steps.value_and_grad(lf_plain, params),
            injecting(routes))
        rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
        err = worst(g, g_p)
        held = "the K8 run's expert choices injected"
    check(rel <= LOGIT_REL and err <= GRAD_REL,
          f"(c) K8 against the plain scan: loss {rel}, worst gradient leaf "
          f"{err} x its max |g|")
    check(all(bool(torch.isfinite(t).all()) for t in pt.leaves(g)),
          "(c) gradient not finite")
    out[f"{name} loss grad B=1 S={S} ms"] = [g_ms, g2_ms]
    out[f"{name} loss grad B=1 S={S} plain scan ms"] = p_ms
    out[f"{name} fedavg step ms"] = step_ms
    out[f"{name} fedavg step peak GiB"] = peak
    print(f"  (c) loss_fn B=1 S={S} remat=full: {float(loss):.6f}; its "
          f"gradient {g_ms:.2f}, {g2_ms:.2f} ms (CUDA events), two runs "
          f"bitwise equal; K8 {2 * n_mamba} + K8-bwd {n_mamba} launches; "
          f"against the plain scan (remat none, {p_ms:.1f} ms, {held}): "
          f"loss rel "
          f"{rel:.2e} (<= {LOGIT_REL:g}), worst leaf {err:.2e} x its max "
          f"|g| (<= {GRAD_REL:g}); routing choices that differ between "
          f"the two runs: {flips} of {sum(r.idx.numel() for r in routes)}")
    print(f"  (d) make_fedavg_step, B=1 S={S} remat=full: "
          f"{step_ms[0]:.2f} ms the first call at this size, "
          f"{step_ms[1]:.2f} ms the second (CUDA events); its loss bitwise "
          f"(c)'s, its params bitwise params - eta g of (c)'s gradient; "
          f"card peak {peak:.2f} GiB (4 x {n_params * 4 / 2 ** 30:.2f} GiB "
          f"of params and gradient buffers and the activations)")
    del g, g_p, params, routes, plain_routes
    torch.cuda.empty_cache()

    # (e) at one layer: 3 feddane steps at S=4096, then 3 at
    # JAMBA_STEP_CMP_S against the plain scan's (its Python loop of the
    # step takes ~16 s a gradient a layer at S=4096), a pipelined step
    cfg1 = jamba_cut(JAMBA_STEP_LAYERS)
    p1 = init_on_card(torch, model_specs(cfg1), 0)
    zeros = pt.tmap(torch.zeros_like, p1)
    fd = steps.make_feddane_round_step(cfg1, eta=JAMBA_STEP_ETA, mu=0.01,
                                       remat="full")

    def three_steps(batch, record):
        st, losses = {"params": p1, "anchor": p1, "g_t": zeros}, []
        for _ in range(3):
            ((st, m), ms), n = launches(lambda: events(lambda: fd(st,
                                                                  batch)))
            losses.append(float(m["loss"]))
            record.append((ms, n))
        return st, losses

    torch.cuda.reset_peak_memory_stats()
    rec, rec_cmp, rec_plain = [], [], []
    st, losses = three_steps(b, rec)
    peak = peak_gib()
    for _, n in rec:
        check({k: n.get(k, 0) for k in k8} == {k8[0]: 4, k8[1]: 2},
              f"(e) a feddane step launched {n}, not K8 4 and K8-bwd 2 "
              f"times")
    check(losses[-1] < losses[0], f"(e) the loss did not fall: {losses}")
    b_cmp = card_batch(torch, 17, cfg1.vocab_size, 1, JAMBA_STEP_CMP_S)
    st_cmp, losses_cmp = three_steps(b_cmp, rec_cmp)
    st_plain, losses_plain = plain_scan(lambda: three_steps(b_cmp,
                                                            rec_plain))
    diff = max_err(torch, st_cmp["params"], st_plain["params"])
    moved = max_err(torch, st_cmp["params"], p1)
    check(diff <= TRAIN_STEP_TOL and moved >= 10 * TRAIN_STEP_TOL,
          f"(e) params K8 vs the plain scan differ by {diff} (moved "
          f"{moved}); limit {TRAIN_STEP_TOL}")
    del st_plain, st_cmp
    pipe = steps.make_feddane_pipelined_step(cfg1, eta=JAMBA_STEP_ETA,
                                             mu=0.01, remat="full")
    torch.cuda.reset_peak_memory_stats()
    ((new, m), pipe_ms), n = launches(lambda: events(lambda: pipe(st, b)))
    pipe_peak = peak_gib()
    check(np.isfinite(float(m["loss"]))
          and {k: n.get(k, 0) for k in k8} == {k8[0]: 2, k8[1]: 1},
          f"(e) the pipelined step: loss {float(m['loss'])}, launches {n}")
    one = f"jamba ({JAMBA_STEP_LAYERS} layer)"
    out[f"{one} feddane S={S} ms a step"] = [r[0] for r in rec]
    out[f"{one} feddane S={JAMBA_STEP_CMP_S} ms a step"] = [
        r[0] for r in rec_cmp]
    out[f"{one} feddane S={JAMBA_STEP_CMP_S}, plain scan, ms a step"] = [
        r[0] for r in rec_plain]
    out[f"{one} feddane S={S} peak GiB"] = peak
    out[f"{one} pipelined step S={S} ms"] = pipe_ms
    out[f"{one} pipelined step S={S} peak GiB"] = pipe_peak
    print(f"  (e) {one}, {param_count(model_specs(cfg1)):,} params, "
          f"make_feddane_round_step B=1 remat=full eta={JAMBA_STEP_ETA:g}, "
          f"3 steps: at S={S} losses {[round(x, 6) for x in losses]}, ms a "
          f"step {[round(r[0], 2) for r in rec]}, card peak {peak:.2f} GiB, "
          f"K8 4 + K8-bwd 2 launches a step; at S={JAMBA_STEP_CMP_S} losses "
          f"{[round(x, 6) for x in losses_cmp]} (plain scan "
          f"{[round(x, 6) for x in losses_plain]}), ms a step "
          f"{[round(r[0], 2) for r in rec_cmp]} (plain scan "
          f"{[round(r[0], 1) for r in rec_plain]}), params vs the plain "
          f"scan {diff:.2e} (<= {TRAIN_STEP_TOL:g}; moved {moved:.2e}); the "
          f"pipelined step at S={S} {pipe_ms:.2f} ms, peak {pipe_peak:.2f} "
          f"GiB, launches {n}")
    del st, new, p1, zeros, b, b_cmp
    torch.cuda.empty_cache()

    # (f) launch/train.py's reduced preset against the CPU path
    rcfg = get_arch("jamba-v0.1-52b").reduced(num_layers=1, d_model=128,
                                              vocab_size=256)
    n_mamba = sum(k in (cb.MAMBA, cb.MAMBA_MOE) for k in rcfg.layer_kinds)
    n_attn = len(rcfg.layer_kinds) - n_mamba
    step_counts, first = [], []
    orig_step, orig_init = kops.FlatUpdate.step, kops.FlatUpdate.__init__
    orig_round = FederatedTrainer.round

    def spy_init(self, *a, **kw):
        step_counts.append([dict(counts)])
        return orig_init(self, *a, **kw)

    def spy_step(self, *a, **kw):
        step_counts[-1].append(dict(counts))
        return orig_step(self, *a, **kw)

    def spy_round(self, st):
        new = orig_round(self, st)
        if not first:
            first.append(pt.tmap(torch.clone, new.params))
        return new

    kops.FlatUpdate.step, kops.FlatUpdate.__init__ = spy_step, spy_init
    FederatedTrainer.round = spy_round
    try:
        (res, sel), grew = launches(lambda: train_drawn(
            JAMBA_TRAIN_ARGV + ["--rounds", "2"]))
    finally:
        kops.FlatUpdate.step, kops.FlatUpdate.__init__ = orig_step, \
            orig_init
        FederatedTrainer.round = orig_round
    local_steps = sum(len(c) - 1 for c in step_counts)
    check(grew.get("dane_update_flat") == local_steps == 2 * 4
          and not grew.get("dane_update_2d"),
          f"(f) trainer auto: {grew} (K1 once a local step, {local_steps} "
          f"steps)")
    per_step = {k8[0]: n_mamba, k8[1]: n_mamba, "flash_attention": n_attn,
                "flash_attention_bwd": n_attn}
    for solve in step_counts:
        for a, c in zip(solve, solve[1:]):
            d = _delta(a, c)
            check({k: d.get(k, 0) for k in per_step} == per_step,
                  f"(f) a local step of K=2 launched {d}, not {per_step}")
    (res_leaf, sel_leaf), grew_leaf = launches(lambda: train_drawn(
        JAMBA_TRAIN_ARGV + ["--rounds", "1", "--local-solver", "per_leaf"]))
    # K4 takes the tree's leaves MAX_SEGMENTS at a launch
    chunks = -(-len(pt.leaves(model_specs(rcfg)))
               // dane_update.MAX_SEGMENTS)
    check(grew_leaf.get("dane_update_2d") == 4 * chunks
          and not grew_leaf.get("dane_update_flat"),
          f"(f) per_leaf: {grew_leaf} (K4 {chunks} a local step: the "
          f"tree's leaves {dane_update.MAX_SEGMENTS} at a launch)")
    check(sel_leaf == sel[:len(sel_leaf)]
          and same(res_leaf.state.params, first[0]),
          "(f) per_leaf's round differs from flat's")
    p_cpu, sel_cpu, losses_cpu = cpu_run.result()
    check(sel == sel_cpu, f"(f) selections {sel} on the card, {sel_cpu} on "
                          f"the CPU path")
    diff = max_err(torch, pt.tmap(lambda t: t.cpu(), res.state.params),
                   p_cpu)
    moved = max_err(torch, res.state.params, first[0])
    check(diff <= TRAJECTORY_TOL and moved >= 10 * TRAJECTORY_TOL
          and all(np.isfinite(res.losses)),
          f"(f) params {diff} from the CPU path's after 2 rounds > "
          f"{TRAJECTORY_TOL} (round 2 moved them {moved})")
    out["jamba reduced trainer ms/round"] = res.round_ms
    out["jamba reduced trainer ms/round, per_leaf"] = res_leaf.round_ms
    print(f"  (f) train.py --arch jamba-v0.1-52b --layers 1 "
          f"({param_count(model_specs(rcfg)):,} params: {n_mamba} mamba + "
          f"{n_attn} attention blocks, d={rcfg.d_model}, N="
          f"{rcfg.ssm_state_dim}, {rcfg.moe.num_experts} experts top-"
          f"{rcfg.moe.top_k}) --lr {JAMBA_TRAIN_LR}, feddane N=8 K=2 E=1 "
          f"B=4 S=64: 2 rounds on auto (flat) "
          f"{[round(t, 1) for t in res.round_ms]} ms/round (CUDA events), "
          f"losses {[round(t, 5) for t in res.losses]} (CPU path "
          f"{[round(t, 5) for t in losses_cpu]}); the CPU path's selections "
          f"{sel_cpu}, params within {diff:.2e} (<= {TRAJECTORY_TOL:g}; "
          f"round 2 moved them {moved:.2e}); a local step K8 and K8-bwd "
          f"{n_mamba}, K7 and K7-bwd {n_attn} launches for both clients; "
          f"per_leaf 1 round bitwise equal to flat's "
          f"({res_leaf.round_ms[0]:.1f} ms, K4 {chunks} launches a local "
          f"step); launches flat {grew}")
    p0 = res.state.params
    del res, res_leaf, first[:]

    two = pt.tmap(lambda t: t.unsqueeze(0).expand((2,) + t.shape)
                  .contiguous(), p0)
    rb = card_batch(torch, 65, rcfg.vocab_size, 4, 64)
    bb = {k: torch.stack([v, torch.roll(v, 1, dims=1)])[:, None].expand(
        2, 2, *v.shape).contiguous() for k, v in rb.items()}
    fn2, _ = podfed.make_podfed_round_step(rcfg, local_steps=2, eta=1e-2,
                                           mu=0.01, remat="full")
    ((pnew, pm), pod_ms), grew = launches(lambda: events(lambda: fn2(
        {"params": two, "anchor": two,
         "g_t": pt.tmap(torch.zeros_like, two)}, bb)))
    check(np.isfinite(float(pm["loss"])) and all(
        bool(torch.isfinite(t).all()) for t in pt.leaves(pnew))
        and grew.get(k8[0], 0) > 0 and grew.get(k8[1], 0) > 0,
        f"(f) podfed 2 pods x 2 steps: not finite, or launches {grew}")
    out["jamba reduced podfed 2 pods x 2 steps ms"] = pod_ms
    print(f"      podfed 2 pods x 2 local steps, 1 round: finite, loss "
          f"{float(pm['loss']):.5f}, {pod_ms:.1f} ms, launches {grew}")
    del two, pnew, p0
    torch.cuda.empty_cache()
    return out


#: Phase 11d (b): the 24-layer xlstm-350m gradient held against the
#: plain scans at this (B, S): four chunks of 64 (the plain scans'
#: Python loops take ~20 launches a step and layer).
XLSTM_GRAD_CMP = (1, 256)
#: Phase 11d (b): the relative nudge of the params (times N(0, 1)) whose
#: move of the worst leaf's gradient is printed beside that leaf's error.
XLSTM_NUDGE = 1e-7
#: Phase 11d (a)-(c): the timed gradients' and the steps' (B, S).
XLSTM_TRAIN_S = 4096
#: Phase 11d (c): the steps' eta.
XLSTM_STEP_ETA = 1e-2
#: Phase 11d (d)'s argv of ``launch/train.py`` (the CPU path's run adds
#: ``--device cpu``): the reduced preset, 4 layers at d=128 (dk=64,
#: dh=32), feddane N=8 K=2 E=1 B=4 S=64, without its ``--lr``.
XLSTM_TRAIN_BASE = ["--arch", "xlstm-350m", "--num-devices", "8",
                    "--devices-per-round", "2", "--local-epochs", "1",
                    "--batch-size", "4", "--seq-len", "64",
                    "--samples-per-device", "16", "--seed", "0"]
#: Phase 11d (d)'s lr.  At train.py's default 0.05 the reduced xLSTM's
#: trajectory amplifies rounding, as jamba's does (phase 11c (f)): the
#: CPU path's own run from weights nudged by 1e-7 x N(0, 1) lands far
#: past TRAJECTORY_TOL after 2 rounds (phase 11d (d) measures and prints
#: that spread at both lrs), so no two f32 runs could agree there; 0.005
#: takes smaller steps.
XLSTM_TRAIN_LR = "0.005"
XLSTM_TRAIN_ARGV = XLSTM_TRAIN_BASE + ["--lr", XLSTM_TRAIN_LR]
#: The CPU path's runs of phase 11d (d): (lr, nudge) -> its argv and the
#: nudge of the weights; the first is the one the card is held to.
XLSTM_CPU_RUNS = {(XLSTM_TRAIN_LR, 0.0): XLSTM_TRAIN_ARGV,
                  (XLSTM_TRAIN_LR, 1e-7): XLSTM_TRAIN_ARGV,
                  ("0.05", 0.0): XLSTM_TRAIN_BASE + ["--lr", "0.05"],
                  ("0.05", 1e-7): XLSTM_TRAIN_BASE + ["--lr", "0.05"]}


def xlstm_cpu_jobs(pool):
    """Phase 11d (d)'s CPU-path runs (:data:`XLSTM_CPU_RUNS`), submitted
    to ``pool``: {(lr, nudge): future}."""
    return {key: pool.submit(_pooled_train, argv + ["--rounds", "2",
                                                    "--device", "cpu"],
                             key[1])
            for key, argv in XLSTM_CPU_RUNS.items()}


def xlstm_train_phase(torch, counts, cpu_runs):
    """Phase 11d: training xlstm-350m at full width and depth (24 layers,
    random weights drawn on the card from seed 0, f32): (a) one mLSTM and
    one sLSTM mixer's gradient through K9/K10 and K9-bwd/K10-bwd against
    autograd of the plain scans on the card at B=1 S=XLSTM_MIXER_CMP_S,
    then timed at B=1 S=4096; (b)
    ``loss_fn``'s gradient, remat="full", at XLSTM_GRAD_CMP against the
    plain scans' route (remat none), then timed at B=1 S=4096 with its
    peak; (c) a fedavg step (params - eta g of (b)'s gradient, bitwise),
    3 ``make_feddane_round_step`` steps and a pipelined step at B=1
    S=4096, with peaks; (d) the reduced preset's ``train.main`` against
    the CPU path (``cpu_runs``: :func:`xlstm_cpu_jobs`, futures of the
    pool), per_leaf, and pods 2 x 2.  Returns timings (ms) and peaks
    (GiB)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.kernels import dane_update, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import podfed, steps
    from repro_torch.models import model_specs, param_count, transformer
    from repro_torch.models import xlstm

    out = {}
    fwd, bwd = ("mlstm_scan", "slstm_scan"), ("mlstm_scan_bwd",
                                              "slstm_scan_bwd")
    launches = functools.partial(launches_of, torch, counts)
    events = functools.partial(cuda_events, torch)
    peak_gib = functools.partial(card_peak_gib, torch)

    def plain(fn):
        with swapped(xlstm, "mlstm_scan", ref.mlstm_scan_ref), \
                swapped(xlstm, "slstm_scan", ref.slstm_scan_ref):
            return fn()

    def took(n, per_kind_fwd, per_kind_bwd):
        return ({k: n.get(k, 0) for k in fwd + bwd}
                == dict.fromkeys(fwd, per_kind_fwd)
                | dict.fromkeys(bwd, per_kind_bwd))

    cfg = get_arch("xlstm-350m")
    name = "xlstm-350m"
    L = cfg.num_layers // len(cfg.pattern)      # layers of each kind
    S = XLSTM_TRAIN_S
    params = init_on_card(torch, model_specs(cfg), 0)
    n_params = param_count(model_specs(cfg))
    print(f"  {name} at full width and depth ({cfg.num_layers} layers: {L} "
          f"sLSTM, {L} mLSTM): {n_params:,} params "
          f"({n_params * 4 / 2 ** 30:.2f} GiB f32), drawn on the card")

    # (a) one mixer of each kind: x and every leaf, the kernels vs autograd
    # of the plain scan at XLSTM_MIXER_CMP_S, then timed at S
    gen = card_generator(torch, 5)
    x = torch.randn(1, S, cfg.d_model, generator=gen, device=gen.device)
    w = torch.randn(1, S, cfg.d_model, generator=gen, device=gen.device)
    S_cmp = XLSTM_MIXER_CMP_S
    for kind, pos in (("mlstm", "pos_1"), ("slstm", "pos_0")):
        layer = pt.tmap(lambda a: a[0], params["stack"][pos][kind])
        mix = getattr(xlstm, f"{kind}_mixer")

        def mixer_grad(s):
            xs = [t.detach().requires_grad_(True)
                  for t in [x[:, :s]] + pt.leaves(layer)]
            p = pt.unflatten(pt.flatten(layer)[1], xs[1:])
            return torch.autograd.grad(
                (mix(p, xs[0], cfg) * w[:, :s]).sum(), xs)

        (got, cmp_ms), n = launches(lambda: events(
            lambda: mixer_grad(S_cmp)))
        k = f"{kind}_scan"
        check({c: n.get(c, 0) for c in (k, k + "_bwd")} == {k: 1,
                                                          k + "_bwd": 1},
              f"(a) the {kind} mixer's gradient launched {n}")
        want, plain_ms = events(lambda: plain(lambda: mixer_grad(S_cmp)))
        err = worst_rel(got, want)
        check(all(bool(torch.isfinite(g).all()) for g in got)
              and err <= GRAD_REL, f"(a) the {kind} mixer's gradient "
                                   f"differs from the plain scan's by {err} "
                                   f"x max |g|")
        del got, want
        (got, ms), n = launches(lambda: events(lambda: mixer_grad(S)))
        check({c: n.get(c, 0) for c in (k, k + "_bwd")} == {k: 1,
                                                          k + "_bwd": 1}
              and all(bool(torch.isfinite(g).all()) for g in got),
              f"(a) the {kind} mixer's S={S} gradient launched {n}, or is "
              f"not finite")
        ms = [ms, events(lambda: mixer_grad(S))[1]]
        out[f"{name} {kind}_mixer grad B=1 S={S} ms"] = ms
        out[f"{name} {kind}_mixer grad B=1 S={S_cmp} ms"] = cmp_ms
        out[f"{name} {kind}_mixer grad B=1 S={S_cmp} plain scan ms"] = \
            plain_ms
        print(f"  (a) {kind}_mixer's gradient (x and {len(got) - 1} weights),"
              f" B=1 S={S_cmp}: worst leaf {err:.2e} x its max |g| (<= "
              f"{GRAD_REL:g}) against autograd of the plain scan; {k} + "
              f"{k}_bwd once; {cmp_ms:.2f} ms, plain scan {plain_ms:.1f} ms; "
              f"at S={S}: {ms[0]:.2f}, {ms[1]:.2f} ms (CUDA events)")
        del got
        torch.cuda.empty_cache()
    del x, w

    # (b) the 24-layer loss's gradient against the plain scans, then timed
    B_cmp, S_cmp = XLSTM_GRAD_CMP
    b = card_batch(torch, S_cmp + 7, cfg.vocab_size, B_cmp, S_cmp)
    (loss, g), n = launches(lambda: steps.value_and_grad(
        lambda p: transformer.loss_fn(p, b, cfg, remat="full"), params))
    check(took(n, 2 * L, L), f"(b) a gradient under remat full launched "
                             f"{n}, not K9/K10 {2 * L} and K9-bwd/K10-bwd "
                             f"{L} times each")
    (loss_p, g_p), p_ms = events(lambda: plain(lambda: steps.value_and_grad(
        lambda p: transformer.loss_fn(p, b, cfg, remat="none"), params)))
    rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    rels = leaf_rels(g, g_p)
    err = max(rels)
    worst = rels.index(err)
    print(f"  (b) loss_fn B={B_cmp} S={S_cmp} remat=full: loss "
          f"{float(loss):.6f}, rel {rel:.2e} (<= {LOGIT_REL:g}) and worst "
          f"gradient leaf {err:.2e} x its max |g| (<= {GRAD_REL:g}) against "
          f"the plain scans (remat none, {p_ms:.1f} ms); launches {n}")
    del g_p
    # the worst leaf's own spread: the same gradient through the kernels
    # from params nudged by XLSTM_NUDGE x |p| x N(0, 1)
    gen = card_generator(torch, 11)
    nudged_p = pt.tmap(lambda t: t + XLSTM_NUDGE * t.abs() * torch.randn(
        t.shape, generator=gen, device=t.device), params)
    _, g_n = steps.value_and_grad(
        lambda p: transformer.loss_fn(p, b, cfg, remat="full"), nudged_p)
    spreads = leaf_rels(g_n, g)
    print(f"      the worst leaf is {leaf_names(params)[worst]}; a "
          f"{XLSTM_NUDGE:g} x |p| nudge of the params moves it "
          f"{spreads[worst]:.2e} x its max |g| through the kernels (error "
          f"/ spread {err / max(spreads[worst], 1e-30):.3g}); the largest "
          f"leaf spread {max(spreads):.2e} "
          f"({leaf_names(params)[spreads.index(max(spreads))]})")
    check(rel <= LOGIT_REL and err <= GRAD_REL
          and all(bool(torch.isfinite(t).all()) for t in pt.leaves(g)),
          f"(b) B={B_cmp} S={S_cmp}: loss {rel}, worst gradient leaf {err} "
          f"x its max |g| against the plain scans")
    check(all(bool(torch.isfinite(t).all()) for t in pt.leaves(g_n)),
          "(b) the nudged gradient is not finite")
    del g, g_n, nudged_p
    b = card_batch(torch, S + 9, cfg.vocab_size, 1, S)
    lf = lambda p: transformer.loss_fn(p, b, cfg, remat="full")  # noqa
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ((loss, g), g_ms), n = launches(lambda: events(
        lambda: steps.value_and_grad(lf, params)))
    g_peak = peak_gib()
    check(took(n, 2 * L, L), f"(b) the S={S} gradient launched {n}")
    (loss2, g2), g2_ms = events(lambda: steps.value_and_grad(lf, params))
    check(torch.equal(loss, loss2) and same_bits(g, g2)
          and all(bool(torch.isfinite(t).all()) for t in pt.leaves(g)),
          f"(b) two S={S} gradients differ, or are not finite")
    del g2
    out[f"{name} loss grad B=1 S={S} ms"] = [g_ms, g2_ms]
    out[f"{name} loss grad B=1 S={S} peak GiB"] = g_peak
    print(f"      at B=1 S={S}: loss {float(loss):.6f}, its gradient "
          f"{g_ms:.2f}, {g2_ms:.2f} ms (CUDA events), two runs bitwise "
          f"equal, card peak {g_peak:.2f} GiB")

    # (c) the steps at B=1 S=4096, remat full
    eta = XLSTM_STEP_ETA
    fa = steps.make_fedavg_step(cfg, eta=eta, remat="full")
    torch.cuda.reset_peak_memory_stats()
    ((new, m), fa_ms), n = launches(lambda: events(
        lambda: fa({"params": params}, b)))
    fa_peak = peak_gib()
    check(took(n, 2 * L, L), f"(c) the fedavg step launched {n}")
    check(torch.equal(m["loss"], loss) and all(
        torch.equal(a, p - t * eta) for a, p, t in zip(
            pt.leaves(new["params"]), pt.leaves(params), pt.leaves(g))),
        "(c) the fedavg step is not params - eta g of (b)'s gradient")
    del new, g
    torch.cuda.empty_cache()
    zeros = pt.tmap(torch.zeros_like, params)
    fd = steps.make_feddane_round_step(cfg, eta=eta, mu=0.01, remat="full")
    st, losses, fd_ms = {"params": params, "anchor": params,
                         "g_t": zeros}, [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        ((st, m), ms), n = launches(lambda: events(lambda: fd(st, b)))
        check(took(n, 4 * L, 2 * L), f"(c) a feddane step launched {n}")
        losses.append(float(m["loss"]))
        fd_ms.append(ms)
    fd_peak = peak_gib()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0]
          and all(bool(torch.isfinite(t).all())
                  for t in pt.leaves(st["params"])),
          f"(c) the feddane steps' losses {losses}")
    pipe = steps.make_feddane_pipelined_step(cfg, eta=eta, mu=0.01,
                                             remat="full")
    torch.cuda.reset_peak_memory_stats()
    ((new, m), pipe_ms), n = launches(lambda: events(lambda: pipe(st, b)))
    pipe_peak = peak_gib()
    check(np.isfinite(float(m["loss"])) and took(n, 2 * L, L),
          f"(c) the pipelined step: loss {float(m['loss'])}, launches {n}")
    out[f"{name} fedavg step S={S} ms"] = fa_ms
    out[f"{name} fedavg step S={S} peak GiB"] = fa_peak
    out[f"{name} feddane S={S} ms a step"] = fd_ms
    out[f"{name} feddane S={S} peak GiB"] = fd_peak
    out[f"{name} pipelined step S={S} ms"] = pipe_ms
    out[f"{name} pipelined step S={S} peak GiB"] = pipe_peak
    print(f"  (c) B=1 S={S} remat=full eta={eta:g}: make_fedavg_step "
          f"{fa_ms:.2f} ms (its params bitwise params - eta g of (b)), peak "
          f"{fa_peak:.2f} GiB; 3 make_feddane_round_step steps, losses "
          f"{[round(x, 6) for x in losses]}, ms {[round(x, 2) for x in fd_ms]}"
          f", peak {fd_peak:.2f} GiB (K9/K10 {4 * L} + K9-bwd/K10-bwd "
          f"{2 * L} launches a step); the pipelined step {pipe_ms:.2f} ms, "
          f"peak {pipe_peak:.2f} GiB")
    del st, new, params, zeros, b
    torch.cuda.empty_cache()

    # (d) launch/train.py's reduced preset against the CPU path
    rcfg = get_arch("xlstm-350m").reduced(num_layers=2, d_model=128,
                                          vocab_size=256)
    rL = rcfg.num_layers // len(rcfg.pattern)
    step_counts, first = [], []
    orig_step, orig_init = kops.FlatUpdate.step, kops.FlatUpdate.__init__
    orig_round = FederatedTrainer.round

    def spy_init(self, *a, **kw):
        step_counts.append([dict(counts)])
        return orig_init(self, *a, **kw)

    def spy_step(self, *a, **kw):
        step_counts[-1].append(dict(counts))
        return orig_step(self, *a, **kw)

    def spy_round(self, st):
        new = orig_round(self, st)
        if not first:
            first.append(pt.tmap(torch.clone, new.params))
        return new

    kops.FlatUpdate.step, kops.FlatUpdate.__init__ = spy_step, spy_init
    FederatedTrainer.round = spy_round
    try:
        (res, sel), grew = launches(lambda: train_drawn(
            XLSTM_TRAIN_ARGV + ["--rounds", "2"]))
    finally:
        kops.FlatUpdate.step, kops.FlatUpdate.__init__ = orig_step, \
            orig_init
        FederatedTrainer.round = orig_round
    local_steps = sum(len(c) - 1 for c in step_counts)
    check(grew.get("dane_update_flat") == local_steps == 2 * 4
          and not grew.get("dane_update_2d"),
          f"(d) trainer auto: {grew} (K1 once a local step, {local_steps} "
          f"steps)")
    for solve in step_counts:
        for a, c in zip(solve, solve[1:]):
            d = _delta(a, c)
            check(took(d, rL, rL), f"(d) a local step of K=2 launched {d}, "
                                   f"not K9/K10/K9-bwd/K10-bwd {rL} each")
    (res_leaf, sel_leaf), grew_leaf = launches(lambda: train_drawn(
        XLSTM_TRAIN_ARGV + ["--rounds", "1", "--local-solver", "per_leaf"]))
    chunks = -(-len(pt.leaves(model_specs(rcfg)))
               // dane_update.MAX_SEGMENTS)
    check(grew_leaf.get("dane_update_2d") == 4 * chunks
          and not grew_leaf.get("dane_update_flat"),
          f"(d) per_leaf: {grew_leaf} (K4 {chunks} a local step)")
    check(sel_leaf == sel[:len(sel_leaf)]
          and same_bits(res_leaf.state.params, first[0]),
          "(d) per_leaf's round differs from flat's")
    cpu = {key: f.result() for key, f in cpu_runs.items()}
    p_cpu, sel_cpu, losses_cpu = cpu[(XLSTM_TRAIN_LR, 0.0)]
    spread = {lr: max_err(torch, cpu[(lr, 1e-7)][0], cpu[(lr, 0.0)][0])
              for lr in (XLSTM_TRAIN_LR, "0.05")}
    check(sel == sel_cpu, f"(d) selections {sel} on the card, {sel_cpu} on "
                          f"the CPU path")
    diff = max_err(torch, pt.tmap(lambda t: t.cpu(), res.state.params),
                   p_cpu)
    moved = max_err(torch, res.state.params, first[0])
    check(diff <= TRAJECTORY_TOL and moved >= 10 * TRAJECTORY_TOL
          and all(np.isfinite(res.losses)),
          f"(d) params {diff} from the CPU path's after 2 rounds > "
          f"{TRAJECTORY_TOL} (round 2 moved them {moved})")
    out[f"{name} reduced trainer: CPU path's 1e-7-nudge spread by lr"] = \
        spread
    out[f"{name} reduced trainer ms/round"] = res.round_ms
    out[f"{name} reduced trainer ms/round, per_leaf"] = res_leaf.round_ms
    print(f"  (d) train.py --arch {name} ({param_count(model_specs(rcfg)):,} "
          f"params: {rcfg.num_layers} layers, d={rcfg.d_model}), feddane N=8 "
          f"K=2 E=1 B=4 S=64: 2 rounds on auto (flat) "
          f"{[round(t, 1) for t in res.round_ms]} ms/round (CUDA events), "
          f"--lr {XLSTM_TRAIN_LR}, losses {[round(t, 5) for t in res.losses]}"
          f" (CPU path {[round(t, 5) for t in losses_cpu]}); selections "
          f"equal the CPU path's, params within {diff:.2e} (<= "
          f"{TRAJECTORY_TOL:g}; round 2 moved them {moved:.2e}); the CPU "
          f"path's own run from weights nudged by 1e-7 lands "
          f"{spread[XLSTM_TRAIN_LR]:.2e} away at this lr, "
          f"{spread['0.05']:.2e} at train.py's default 0.05; a local step "
          f"K9, K10, K9-bwd, K10-bwd"
          f" {rL} each for both clients; per_leaf 1 round bitwise equal to "
          f"flat's ({res_leaf.round_ms[0]:.1f} ms, K4 {chunks} launches a "
          f"local step); launches flat {grew}")
    p0 = res.state.params
    del res, res_leaf, first[:]

    two = pt.tmap(lambda t: t.unsqueeze(0).expand((2,) + t.shape)
                  .contiguous(), p0)
    rb = card_batch(torch, 65, rcfg.vocab_size, 4, 64)
    bb = {k: torch.stack([v, torch.roll(v, 1, dims=1)])[:, None].expand(
        2, 2, *v.shape).contiguous() for k, v in rb.items()}
    fn2, _ = podfed.make_podfed_round_step(rcfg, local_steps=2, eta=1e-2,
                                           mu=0.01, remat="full")
    ((pnew, pm), pod_ms), grew = launches(lambda: events(lambda: fn2(
        {"params": two, "anchor": two,
         "g_t": pt.tmap(torch.zeros_like, two)}, bb)))
    check(np.isfinite(float(pm["loss"])) and all(
        bool(torch.isfinite(t).all()) for t in pt.leaves(pnew))
        and all(grew.get(k, 0) > 0 for k in fwd + bwd),
        f"(d) podfed 2 pods x 2 steps: not finite, or launches {grew}")
    out[f"{name} reduced podfed 2 pods x 2 steps ms"] = pod_ms
    print(f"      podfed 2 pods x 2 local steps, 1 round: finite, loss "
          f"{float(pm['loss']):.5f}, {pod_ms:.1f} ms, launches {grew}")
    del two, pnew, p0
    torch.cuda.empty_cache()
    return out


#: Phases 10e and 11e: Whisper's start-of-transcript token, the decoder's
#: first input (any id serves a random model; this one is the model's).
WHISPER_BOS = 50258
#: Phase 10e (a): the prefills' (B, frames), one BOS token each: Whisper's
#: 30-s window of 1,500 frames at B=8, and the repo's long prompt.
WHISPER_PREFILLS = ((8, 1500), (1, 4096))
#: Phase 10e (b)-(c): the decode batch, the prompt, the new tokens, the
#: self-attention cache and the frames that fill the cross caches.
WHISPER_SERVE = dict(B=2, prompt=4, new=8, cache_len=64, frames=1500)
#: Phase 11e (a)-(b): the gradient's (B, frames, tokens): Whisper's 30-s
#: window against its decoder's 448 positions.
WHISPER_TRAIN = (8, 1500, 448)
#: Phase 11e (b): the steps' eta and the repo's long sequence (frames =
#: tokens = S at B=1).
WHISPER_STEP_ETA = 1e-2
WHISPER_LONG_S = 4096
#: Phase 11e (c)'s argv of ``launch/train.py`` (the CPU path's runs add
#: ``--device cpu``): the reduced preset, 2 encoder + 2 decoder layers at
#: d=128, V=256, zero frames, feddane N=8 K=2 E=1 B=4 S=64 at train.py's
#: lr 0.05.
WHISPER_TRAIN_ARGV = ["--arch", "whisper-tiny", "--num-devices", "8",
                      "--devices-per-round", "2", "--local-epochs", "1",
                      "--batch-size", "4", "--seq-len", "64",
                      "--samples-per-device", "16", "--seed", "0"]
#: Phase 11e (c)'s CPU-path runs: name -> (nudge, relative).  The zero
#: frames meet every encoder ``rms_norm`` at 0, where its derivative is
#: rsqrt(1e-6) = 1,000: the encoder's MLP biases grow to ~1e6 in 2
#: rounds.  A nudge of w by 1e-7 x N(0, 1) x w ("relative") keeps the
#: zero-initialised leaves at 0 and measures rounding's amplification;
#: 1e-7 x N(0, 1) added to every leaf ("additive") moves the encoder off
#: that point, which changes the run by about all of each leaf.
WHISPER_CPU_RUNS = {"w0": (0.0, False), "relative": (1e-7, True),
                    "additive": (1e-7, False)}
#: Phase 11e (d): the full-size trainer's argv, 1 round.
WHISPER_FULL_ARGV = WHISPER_TRAIN_ARGV + ["--full-size", "--rounds", "1"]


def whisper_cpu_jobs(pool):
    """Phase 11e (c)'s CPU-path runs (:data:`WHISPER_CPU_RUNS`), submitted
    to ``pool``: {name: future}."""
    argv = WHISPER_TRAIN_ARGV + ["--rounds", "2", "--device", "cpu"]
    return {key: pool.submit(_pooled_train, argv, nudge, relative)
            for key, (nudge, relative) in WHISPER_CPU_RUNS.items()}


def leaf_rel(torch, got, want) -> float:
    """The worst leaf's max |got - want| over max(1, its max |want|)."""
    from repro_torch.core import pytree as pt
    return max(float((a.float().cpu() - b.float().cpu()).abs().max())
               / max(1.0, float(b.float().abs().max()))
               for a, b in zip(pt.leaves(got), pt.leaves(want)))


def whisper_phase(torch, counts):
    """Phase 10e: whisper-tiny at full width and full depth (4 encoder + 4
    decoder layers, 56,371,200 params), random weights drawn on the card
    from seed 0, f32: (a) ``make_prefill_step`` on the reference's serving
    batch (frames, one BOS token) at WHISPER_PREFILLS against the plain
    attention on the card, K7 exactly 12 times a prefill (encoder self,
    decoder self, cross), ms a prefill and the idle share of one; (b) 3
    ``decode_step`` calls on random ``ck`` / ``cv`` against the CPU
    path's; (c) ``serve.generate`` with frames against the port's own
    teacher-forced forward (the logits at every prompt position, the
    greedy tokens) and without frames against the CPU path's loop; (d)
    ms a decode step.  Returns the timings (ms) and the idle share."""
    from repro_torch.configs import get_arch
    from repro_torch.core import pytree as pt
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import (attention, model_specs, param_count,
                                    transformer)

    out = {}
    name = "whisper-tiny"
    cfg = get_arch(name)
    n_attn = cfg.num_encoder_layers + 2 * cfg.num_layers
    t0 = time.perf_counter()
    params = init_on_card(torch, model_specs(cfg), 0)
    torch.cuda.synchronize()
    dev = pt.leaves(params)[0].device
    print(f"  {name} at full width and depth ({cfg.num_encoder_layers} "
          f"encoder + {cfg.num_layers} decoder layers, d={cfg.d_model}, "
          f"H={cfg.num_heads}, d_ff={cfg.d_ff}, V={cfg.vocab_size}): "
          f"{param_count(model_specs(cfg)):,} params (f32), drawn on the "
          f"card in {time.perf_counter() - t0:.2f} s")
    gen = card_generator(torch, 11)

    def plain(fn):
        with swapped(attention, "attention", attention.plain_attention):
            return fn()

    def frames(B, T):
        return torch.randn(B, T, cfg.d_model, generator=gen,
                           device=gen.device)

    # (a) the prefill: the encoder over T frames, one BOS token decoded
    step = make_prefill_step(cfg)
    for B, T in WHISPER_PREFILLS:
        batch = {"frames": frames(B, T),
                 "tokens": torch.full((B, 1), WHISPER_BOS, dtype=torch.int32,
                                      device=dev)}
        logits, n = launches_of(torch, counts, lambda: step(params, batch))
        check(logits.shape == (B, 1, cfg.vocab_size),
              f"{name}: shape {tuple(logits.shape)}")
        check(n == {"flash_attention": n_attn},
              f"{name} B={B} T={T}: one prefill launched {n}, not K7 "
              f"{n_attn} times")
        want = plain(lambda: step(params, batch))
        compare_logits(torch, f"(a) {name} prefill B={B} frames={T}, K7 vs "
                              f"plain attention on the card", logits, want)
        ms = cuda_ms(torch, lambda: step(params, batch), 1, repeats=3)
        plain_ms = cuda_ms(torch, lambda: plain(lambda: step(params, batch)),
                           1, repeats=3)
        out[f"{name} prefill B={B} frames={T}"] = ms
        out[f"{name} prefill B={B} frames={T} plain attention"] = plain_ms
        print(f"    {ms:.2f} ms a prefill ({B * T / ms * 1e3:.0f} frames/s), "
              f"plain attention {plain_ms:.2f} ms (CUDA events, median of "
              f"3); K7 {n_attn} launches")
        if B == WHISPER_PREFILLS[0][0]:
            out[f"idle share, {name} B={B} frames={T} prefill"] = \
                device_share(torch, lambda: step(params, batch),
                             f"{name} B={B} frames={T} prefill")
        del batch, logits, want

    # (b) decode steps from equal random cross caches, card vs CPU path
    sv = WHISPER_SERVE
    B, cache_len, T = sv["B"], sv["cache_len"], sv["frames"]
    specs = transformer.decode_cache_specs(cfg, B, cache_len, T)
    cache = pt.tmap(lambda s: (torch.randn(s.shape, generator=gen,
                                           device=gen.device)
                               if s.shape[2] == T else
                               torch.zeros(s.shape, device=dev)), specs)
    params_cpu = pt.tmap(lambda a: a.cpu(), params)
    cache_cpu = pt.tmap(lambda a: a.cpu(), cache)
    toks = card_tokens(torch, 29, cfg.vocab_size, 3, B)
    before = dict(counts)
    for t in range(3):
        batch = {"tokens": toks[t][:, None], "t": t}
        logits, cache = transformer.decode_step(params, batch, cache, cfg)
        want, cache_cpu = transformer.decode_step(
            params_cpu, pt.tmap(lambda a: a.cpu() if torch.is_tensor(a)
                                else a, batch), cache_cpu, cfg)
        compare_logits(torch, f"(b) {name} decode step t={t} (B={B}, "
                              f"random ck/cv of {T} rows), card vs CPU path",
                       logits, want)
    check(_delta(before, counts) == {}, f"{name}: the decode path launched "
                                        f"a kernel")
    out[f"{name} decode step ms (B={B}, ck/cv {T} rows)"] = cuda_ms(
        torch, lambda: transformer.decode_step(
            params, {"tokens": toks[0][:, None], "t": 3}, cache, cfg), 1,
        repeats=3)
    print(f"    (d) a decode step: "
          f"{out[f'{name} decode step ms (B={B}, ck/cv {T} rows)']:.2f} ms "
          f"(CUDA events, median of 3)")
    del cache, cache_cpu

    # (c) serve.generate with frames against the teacher-forced forward,
    # and without against the CPU path's loop (the reference's zero cross
    # caches)
    P, new = sv["prompt"], sv["new"]
    prompt = torch.cat([torch.full((B, 1), WHISPER_BOS, dtype=torch.int32,
                                   device=dev),
                        card_tokens(torch, 31, cfg.vocab_size, B, P - 1)], 1)
    f = frames(B, T)
    gen_f, n = launches_of(torch, counts, lambda: serve.generate(
        params, cfg, prompt, new, cache_len, frames=f))
    check(n == {"flash_attention": cfg.num_encoder_layers},
          f"{name} serve with frames launched {n}, not K7 once an encoder "
          f"layer")
    fed = torch.cat([gen_f.prompt_logits.argmax(-1), gen_f.tokens], 1)
    seq = torch.cat([prompt, fed.to(prompt.dtype)], 1)
    with torch.no_grad():
        forced = transformer._logits(params, transformer.forward_hidden(
            params, {"tokens": seq, "frames": f}, cfg), cfg)
    check(torch.equal(forced[:, P - 1:-1].argmax(-1), fed),
          f"{name} serve with frames: greedy tokens {fed.tolist()} are not "
          f"the teacher-forced forward's argmax "
          f"{forced[:, P - 1:-1].argmax(-1).tolist()}")
    # the decode path's logits after each prompt token
    cache = pt.tmap(lambda s: torch.zeros(s.shape, device=dev),
                    transformer.decode_cache_specs(cfg, B, cache_len, T))
    transformer.fill_cross_cache(params, f, cache, cfg)
    worst = 0.0
    for t in range(P):
        logits, cache = transformer.decode_step(
            params, {"tokens": prompt[:, t:t + 1], "t": t}, cache, cfg)
        ok, err, scale = logits_agree(torch, logits[:, 0], forced[:, t])
        check(ok, f"{name} serve with frames: the decode path's logits at "
                  f"position {t} differ from the forward's by {err} (bound "
                  f"{LOGIT_REL} x {scale}) or their argmax differs")
        worst = max(worst, err / scale)
    out[f"{name} serve ms per decode step (B={B}, frames)"] = \
        gen_f.decode_s / new * 1e3
    gen0 = serve.generate(params, cfg, prompt, new, cache_len)
    t0 = time.perf_counter()
    gen0_cpu = serve.generate(params_cpu, cfg, prompt.cpu(), new, cache_len)
    cpu_s = time.perf_counter() - t0
    check(torch.equal(gen0.tokens.cpu(), gen0_cpu.tokens),
          f"{name} serve without frames: greedy tokens differ from the CPU "
          f"path's: {gen0.tokens.tolist()} vs {gen0_cpu.tokens.tolist()}")
    print(f"  (c) serve.generate B={B}, {P}-token prompt, {new} new tokens, "
          f"cache {cache_len}: with {T} frames (ck/cv filled from the "
          f"encoder, K7 {cfg.num_encoder_layers} launches) the logits at "
          f"every prompt position within {worst:.2e} x max |logit| of the "
          f"teacher-forced forward (K7), greedy tokens its argmax "
          f"{fed.tolist()}; "
          f"{out[f'{name} serve ms per decode step (B={B}, frames)']:.2f} ms "
          f"a decode step (host clock); without frames (the reference's "
          f"zero ck/cv) tokens equal the CPU path's {gen0.tokens.tolist()} "
          f"(its run {cpu_s:.1f} s)")
    del params, params_cpu, cache, forced
    torch.cuda.empty_cache()
    return out


def whisper_train_phase(torch, counts, cpu_runs):
    """Phase 11e: training whisper-tiny at full width and depth (random
    weights drawn on the card from seed 0, f32): (a) ``loss_fn``'s
    gradient, ``remat="full"``, at WHISPER_TRAIN (B=8, 1,500 frames, 448
    tokens) with random frames and with the trainer's zero frames,
    against the plain attention's route (remat none) on the card (the
    loss within LOGIT_REL, each leaf within GRAD_REL of its max |g|),
    K7 24 and K7-bwd 12 times, timed with the card's peak; (b) a fedavg
    step (params - eta g of (a)'s gradient, bitwise), 3
    ``make_feddane_round_step`` steps and a pipelined step at that
    shape, then one gradient at B=1, frames = tokens = WHISPER_LONG_S;
    (c) ``train.main`` on WHISPER_TRAIN_ARGV, 2 rounds on ``auto`` (=
    flat) against the CPU path (``cpu_runs``: :func:`whisper_cpu_jobs`;
    params within TRAJECTORY_TOL x max(1, each leaf's max |p|), the CPU
    path's own nudge spreads printed), 1 round on ``per_leaf`` bitwise
    equal to flat's first, pods 2 x 2; (d) one ``--full-size`` round.
    Returns timings (ms) and peaks (GiB)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import FederatedTrainer
    from repro_torch.core import pytree as pt
    from repro_torch.kernels import dane_update
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import podfed, steps
    from repro_torch.models import (attention, model_specs, param_count,
                                    transformer)

    out = {}
    k7 = ("flash_attention", "flash_attention_bwd")
    launches = functools.partial(launches_of, torch, counts)
    events = functools.partial(cuda_events, torch)
    peak_gib = functools.partial(card_peak_gib, torch)

    def plain(fn):
        with swapped(attention, "attention", attention.plain_attention):
            return fn()

    def took(n, fwd, bwd):
        return {k: n.get(k, 0) for k in k7} == {k7[0]: fwd, k7[1]: bwd}

    name = "whisper-tiny"
    cfg = get_arch(name)
    n_attn = cfg.num_encoder_layers + 2 * cfg.num_layers
    params = init_on_card(torch, model_specs(cfg), 0)
    n_params = param_count(model_specs(cfg))
    print(f"  {name} at full width and depth: {n_params:,} params "
          f"({n_params * 4 / 2 ** 30:.2f} GiB f32), drawn on the card; "
          f"{n_attn} attentions a forward")

    # (a) the gradient at Whisper's shape, random and zero frames
    B, T, S = WHISPER_TRAIN
    gen = card_generator(torch, 13)
    toks = card_batch(torch, S + 5, cfg.vocab_size, B, S)
    batches = {"random": dict(toks, frames=torch.randn(
        B, T, cfg.d_model, generator=gen, device=gen.device)),
        "zero": dict(toks, frames=torch.zeros(B, T, cfg.d_model,
                                              device=gen.device))}
    grads = {}
    for kind, b in batches.items():
        lf = lambda p: transformer.loss_fn(p, b, cfg, remat="full")  # noqa
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ((loss, g), ms), n = launches(lambda: events(
            lambda: steps.value_and_grad(lf, params)))
        peak = peak_gib()
        check(took(n, 2 * n_attn, n_attn),
              f"(a) a gradient under remat full ({kind} frames) launched "
              f"{n}, not K7 {2 * n_attn} and K7-bwd {n_attn} times")
        (loss_p, g_p), p_ms = events(lambda: plain(
            lambda: steps.value_and_grad(lambda p: transformer.loss_fn(
                p, b, cfg, remat="none"), params)))
        rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
        err = worst_rel(g, g_p)
        check(rel <= LOGIT_REL and err <= GRAD_REL
              and all(bool(torch.isfinite(t).all()) for t in pt.leaves(g)),
              f"(a) {kind} frames: loss {rel}, worst gradient leaf {err} x "
              f"its max |g| against the plain attention")
        ms2 = events(lambda: steps.value_and_grad(lf, params))[1]
        out[f"{name} loss grad B={B} T={T} S={S} {kind} frames ms"] = \
            [ms, ms2]
        out[f"{name} loss grad B={B} T={T} S={S} {kind} frames plain "
            f"attention ms"] = p_ms
        out[f"{name} loss grad B={B} T={T} S={S} peak GiB"] = peak
        print(f"  (a) loss_fn B={B}, {T} {kind} frames, {S} tokens, "
              f"remat=full: loss {float(loss):.6f}, rel {rel:.2e} (<= "
              f"{LOGIT_REL:g}) and worst gradient leaf {err:.2e} x its max "
              f"|g| (<= {GRAD_REL:g}) against the plain attention (remat "
              f"none, {p_ms:.1f} ms); {ms:.2f}, {ms2:.2f} ms (CUDA events), "
              f"card peak {peak:.2f} GiB; launches {n}")
        grads[kind] = (loss, g)
        del g_p
    loss, g = grads.pop("random")
    del grads
    b = batches["random"]

    # (b) the steps at that shape, then one gradient at the long S
    eta = WHISPER_STEP_ETA
    fa = steps.make_fedavg_step(cfg, eta=eta, remat="full")
    torch.cuda.reset_peak_memory_stats()
    ((new, m), fa_ms), n = launches(lambda: events(
        lambda: fa({"params": params}, b)))
    fa_peak = peak_gib()
    check(took(n, 2 * n_attn, n_attn), f"(b) the fedavg step launched {n}")
    check(torch.equal(m["loss"], loss) and all(
        torch.equal(a, p - t * eta) for a, p, t in zip(
            pt.leaves(new["params"]), pt.leaves(params), pt.leaves(g))),
        "(b) the fedavg step is not params - eta g of (a)'s gradient")
    del new, g
    zeros = pt.tmap(torch.zeros_like, params)
    fd = steps.make_feddane_round_step(cfg, eta=eta, mu=0.01, remat="full")
    st, losses, fd_ms = {"params": params, "anchor": params,
                         "g_t": zeros}, [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        ((st, m), ms), n = launches(lambda: events(lambda: fd(st, b)))
        check(took(n, 4 * n_attn, 2 * n_attn),
              f"(b) a feddane step launched {n}")
        losses.append(float(m["loss"]))
        fd_ms.append(ms)
    fd_peak = peak_gib()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0]
          and all(bool(torch.isfinite(t).all())
                  for t in pt.leaves(st["params"])),
          f"(b) the feddane steps' losses {losses}")
    pipe = steps.make_feddane_pipelined_step(cfg, eta=eta, mu=0.01,
                                             remat="full")
    ((new, m), pipe_ms), n = launches(lambda: events(lambda: pipe(st, b)))
    check(np.isfinite(float(m["loss"])) and took(n, 2 * n_attn, n_attn),
          f"(b) the pipelined step: loss {float(m['loss'])}, launches {n}")
    out[f"{name} fedavg step B={B} ms"] = fa_ms
    out[f"{name} fedavg step peak GiB"] = fa_peak
    out[f"{name} feddane B={B} ms a step"] = fd_ms
    out[f"{name} feddane peak GiB"] = fd_peak
    out[f"{name} pipelined step B={B} ms"] = pipe_ms
    print(f"  (b) B={B} T={T} S={S} remat=full eta={eta:g}: "
          f"make_fedavg_step {fa_ms:.2f} ms (bitwise params - eta g of "
          f"(a)), peak {fa_peak:.2f} GiB; 3 make_feddane_round_step steps, "
          f"losses {[round(x, 6) for x in losses]}, ms "
          f"{[round(x, 2) for x in fd_ms]}, peak {fd_peak:.2f} GiB (K7 "
          f"{4 * n_attn} + K7-bwd {2 * n_attn} a step); the pipelined step "
          f"{pipe_ms:.2f} ms")
    del st, new, zeros, batches, b
    L = WHISPER_LONG_S
    lb = dict(card_batch(torch, L + 3, cfg.vocab_size, 1, L),
              frames=torch.randn(1, L, cfg.d_model, generator=gen,
                                 device=gen.device))
    lf = lambda p: transformer.loss_fn(p, lb, cfg, remat="full")  # noqa
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ((loss, g), ms), n = launches(lambda: events(
        lambda: steps.value_and_grad(lf, params)))
    long_peak = peak_gib()
    check(took(n, 2 * n_attn, n_attn)
          and all(bool(torch.isfinite(t).all()) for t in pt.leaves(g)),
          f"(b) the B=1 S={L} gradient launched {n}, or is not finite")
    ms2 = events(lambda: steps.value_and_grad(lf, params))[1]
    out[f"{name} loss grad B=1 T=S={L} ms"] = [ms, ms2]
    out[f"{name} loss grad B=1 T=S={L} peak GiB"] = long_peak
    print(f"      one gradient at B=1, frames = tokens = {L}: loss "
          f"{float(loss):.6f}, {ms:.2f}, {ms2:.2f} ms (CUDA events), card "
          f"peak {long_peak:.2f} GiB; launches {n}")
    del params, g, lb
    torch.cuda.empty_cache()

    # (c) launch/train.py's reduced preset against the CPU path
    rcfg = get_arch(name).reduced(num_layers=2, d_model=128, vocab_size=256)
    r_attn = rcfg.num_encoder_layers + 2 * rcfg.num_layers
    step_counts, first = [], []
    orig_step, orig_init = kops.FlatUpdate.step, kops.FlatUpdate.__init__
    orig_round = FederatedTrainer.round

    def spy_init(self, *a, **kw):
        step_counts.append([dict(counts)])
        return orig_init(self, *a, **kw)

    def spy_step(self, *a, **kw):
        step_counts[-1].append(dict(counts))
        return orig_step(self, *a, **kw)

    def spy_round(self, st):
        new = orig_round(self, st)
        if not first:
            first.append(pt.tmap(torch.clone, new.params))
        return new

    def spied(fn):
        step_counts[:] = []
        kops.FlatUpdate.step, kops.FlatUpdate.__init__ = spy_step, spy_init
        FederatedTrainer.round = spy_round
        try:
            return launches(fn)
        finally:
            kops.FlatUpdate.step, kops.FlatUpdate.__init__ = orig_step, \
                orig_init
            FederatedTrainer.round = orig_round

    def step_launches(what, fwd, bwd):
        for solve in step_counts:
            for a, c in zip(solve, solve[1:]):
                d = _delta(a, c)
                check(took(d, fwd, bwd), f"{what}: a local step of K=2 "
                                         f"launched {d}, not K7 {fwd} and "
                                         f"K7-bwd {bwd}")
        return sum(len(c) - 1 for c in step_counts)

    (res, sel), grew = spied(lambda: train_drawn(
        WHISPER_TRAIN_ARGV + ["--rounds", "2"]))
    local_steps = step_launches("(c)", r_attn, r_attn)
    check(grew.get("dane_update_flat") == local_steps == 2 * 4
          and not grew.get("dane_update_2d"),
          f"(c) trainer auto: {grew} (K1 once a local step, {local_steps} "
          f"steps)")
    (res_leaf, sel_leaf), grew_leaf = launches(lambda: train_drawn(
        WHISPER_TRAIN_ARGV + ["--rounds", "1", "--local-solver",
                              "per_leaf"]))
    chunks = -(-len(pt.leaves(model_specs(rcfg)))
               // dane_update.MAX_SEGMENTS)
    check(grew_leaf.get("dane_update_2d") == 4 * chunks
          and not grew_leaf.get("dane_update_flat"),
          f"(c) per_leaf: {grew_leaf} (K4 {chunks} a local step)")
    check(sel_leaf == sel[:len(sel_leaf)]
          and same_bits(res_leaf.state.params, first[0]),
          "(c) per_leaf's round differs from flat's")
    cpu = {key: f.result() for key, f in cpu_runs.items()}
    p_cpu, sel_cpu, losses_cpu = cpu["w0"]
    spread = {key: leaf_rel(torch, cpu[key][0], p_cpu)
              for key in ("relative", "additive")}
    check(sel == sel_cpu, f"(c) selections {sel} on the card, {sel_cpu} on "
                          f"the CPU path")
    diff = leaf_rel(torch, res.state.params, p_cpu)
    moved = leaf_rel(torch, res.state.params, first[0])
    check(diff <= TRAJECTORY_TOL and moved >= 10 * TRAJECTORY_TOL
          and all(np.isfinite(res.losses)),
          f"(c) params {diff} x max(1, max |p|) from the CPU path's after 2 "
          f"rounds > {TRAJECTORY_TOL} (round 2 moved them {moved})")
    top = max(float(t.abs().max()) for t in pt.leaves(p_cpu))
    out[f"{name} reduced trainer: CPU path's 1e-7-nudge spreads"] = spread
    out[f"{name} reduced trainer ms/round"] = res.round_ms
    out[f"{name} reduced trainer ms/round, per_leaf"] = res_leaf.round_ms
    print(f"  (c) train.py --arch {name} ({param_count(model_specs(rcfg)):,}"
          f" params: {rcfg.num_encoder_layers} + {rcfg.num_layers} layers, "
          f"d={rcfg.d_model}, zero frames), feddane N=8 K=2 E=1 B=4 S=64 lr "
          f"0.05: 2 rounds on auto (flat) "
          f"{[round(t, 1) for t in res.round_ms]} ms/round (CUDA events), "
          f"losses {[round(t, 5) for t in res.losses]} (CPU path "
          f"{[round(t, 5) for t in losses_cpu]}); selections equal the CPU "
          f"path's, params within {diff:.2e} x max(1, max |p|) (<= "
          f"{TRAJECTORY_TOL:g}; round 2 moved them {moved:.2e}; the largest "
          f"leaf reaches {top:.4g}); the CPU path's own run from weights "
          f"nudged by 1e-7 x w lands {spread['relative']:.2e} away, by 1e-7 "
          f"added {spread['additive']:.2e}; a local step K7 {r_attn} + "
          f"K7-bwd {r_attn} for both clients; per_leaf 1 round bitwise "
          f"equal to flat's ({res_leaf.round_ms[0]:.1f} ms, K4 {chunks} "
          f"launches a local step); launches flat {grew}")
    p0 = res.state.params
    del res, res_leaf, first[:]
    two = pt.tmap(lambda t: t.unsqueeze(0).expand((2,) + t.shape)
                  .contiguous(), p0)
    rb = dict(card_batch(torch, 65, rcfg.vocab_size, 4, 64),
              frames=torch.randn(4, 64, rcfg.d_model, generator=gen,
                                 device=gen.device))
    bb = {k: torch.stack([v, torch.roll(v, 1, dims=1)])[:, None].expand(
        2, 2, *v.shape).contiguous() for k, v in rb.items()}
    fn2, _ = podfed.make_podfed_round_step(rcfg, local_steps=2, eta=1e-2,
                                           mu=0.01, remat="full")
    ((pnew, pm), pod_ms), grew = launches(lambda: events(lambda: fn2(
        {"params": two, "anchor": two,
         "g_t": pt.tmap(torch.zeros_like, two)}, bb)))
    check(np.isfinite(float(pm["loss"])) and all(
        bool(torch.isfinite(t).all()) for t in pt.leaves(pnew))
        and all(grew.get(k, 0) > 0 for k in k7),
        f"(c) podfed 2 pods x 2 steps: not finite, or launches {grew}")
    out[f"{name} reduced podfed 2 pods x 2 steps ms"] = pod_ms
    print(f"      podfed 2 pods x 2 local steps (random frames), 1 round: "
          f"finite, loss {float(pm['loss']):.5f}, {pod_ms:.1f} ms, launches "
          f"{grew}")
    del two, pnew, p0
    torch.cuda.empty_cache()

    # (d) one round of the full-size trainer
    torch.cuda.reset_peak_memory_stats()
    (full, _), grew = spied(lambda: train_drawn(WHISPER_FULL_ARGV))
    full_peak = peak_gib()
    local_steps = step_launches("(d)", n_attn, n_attn)
    check(grew.get("dane_update_flat") == local_steps == 4
          and all(np.isfinite(full.losses)),
          f"(d) the full-size round: {grew} (K1 once a local step, "
          f"{local_steps} steps), losses {full.losses}")
    out[f"{name} full-size trainer ms/round"] = full.round_ms
    out[f"{name} full-size trainer peak GiB"] = full_peak
    print(f"  (d) train.py --arch {name} --full-size, feddane N=8 K=2 E=1 B=4"
          f" S=64, 1 round on auto (flat): {full.round_ms[0]:.1f} ms (CUDA "
          f"events), loss {full.losses[0]:.5f}, card peak {full_peak:.2f} "
          f"GiB; {local_steps} local steps, each K1 once and K7 {n_attn} + "
          f"K7-bwd {n_attn} for both clients; launches {grew}")
    del full
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    pool, threads = cpu_pool()           # its workers start at a submit
    try:
        return run(torch, pool, threads)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run(torch, pool, threads: int) -> int:
    """Phases 1-12 (module docstring); ``pool``, ``threads``: the CPU
    path's workers (:func:`cpu_pool`)."""
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.data import make_femnist_like, make_synthetic
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = smi()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"python {sys.version.split()[0]}  "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[2] kernels built in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        print(f"    --- {name} ---")
        for line in log.strip().splitlines():
            # ptxas -v: each entry's registers and, on the line after its
            # "Function properties", its stack frame and spills
            if "ptxas info" in line or "spill" in line or line.startswith("["):
                print(f"    {line.strip()}")

    t0 = time.perf_counter()
    syn = make_synthetic(1, 1, num_devices=30, seed=0, batch_size=10)
    syn_cpu = make_synthetic(1, 1, num_devices=30, seed=0, batch_size=10,
                             device="cpu")
    fem = make_femnist_like(200, seed=0, batch_size=10)
    fem_cpu = make_femnist_like(200, seed=0, batch_size=10, device="cpu")
    print(f"    data made in {time.perf_counter() - t0:.2f} s")

    print("[3] kernels against their plain versions")
    t0 = time.perf_counter()
    rows = kernel_checks(torch, syn, fem)
    print(f"  phase 3 took {time.perf_counter() - t0:.1f} s")

    counts = build.launch_counts
    build.reset_launch_counts()          # the main path starts here
    phase_ms = {}
    # phases 8 and 8c's CPU path, in the workers while phases 4-8b run
    lstm_jobs = lstm_cpu_jobs(pool)
    buffered_jobs = buffered_cpu_jobs(pool)
    print(f"    the CPU path's runs of phases 8 and 8c go to {CPU_WORKERS} "
          f"spawned workers of {threads} threads each, submitted now")
    t4 = time.perf_counter()
    print("[4] paper config: synthetic(1,1) N=30 K=10 E=20 B=10 lr=0.01")
    for algo in ("feddane", "fedprox", "fedavg"):
        cfg = FederatedConfig(algorithm=algo, mu=0.001, **PAPER)
        before = dict(counts)
        tr, st, phase_ms[algo] = run_pair(torch, syn, syn_cpu, cfg, 5,
                                          algo)
        device_share(torch, lambda: tr.round(st), algo)
        print(f"    launches {_delta(before, counts)}")

    print("[5] feddane, 2 rounds per explicit solver mode")
    from repro_torch.core import FederatedTrainer
    from repro_torch.models.param import init_params
    from repro_torch.data.leaf_like import SENT_VOCAB, SHAKES_VOCAB
    from repro_torch.models.small import (charlstm_specs, logreg_loss,
                                          logreg_specs, sentlstm_specs)
    uses = {"flat": "dane_update_flat", "per_leaf": "dane_update_2d",
            "fused_step": "linear_logistic_step",
            "fused_epoch": "local_epoch"}
    finals, grown = {}, {}
    for mode, kernel in uses.items():
        cfg = FederatedConfig(algorithm="feddane", mu=0.001,
                              local_solver=mode, **PAPER)
        tr = FederatedTrainer(logreg_loss, syn, cfg)
        st = tr.init(init_params(logreg_specs(60, 10),
                                 torch.Generator().manual_seed(0)))
        before = dict(counts)
        start = time.perf_counter()
        for _ in range(2):
            st = tr.round(st)
        torch.cuda.synchronize()
        phase_ms[f"feddane/{mode}"] = (time.perf_counter() - start) / 2e-3
        grew = grown[mode] = _delta(before, counts)
        check(grew.get(kernel, 0) > 0, f"{mode}: {kernel} never launched")
        finals[mode] = st.params
        if mode == "fused_step":
            device_share(torch, lambda: tr.round(st), f"feddane/{mode}")
        print(f"  {mode:11s} {phase_ms[f'feddane/{mode}']:9.2f} ms/round "
              f"(host clock)  launches {grew}")
    for k in ("w", "b"):
        check(torch.equal(finals["flat"][k], finals["per_leaf"][k]),
              "flat and per_leaf differ on the card")
    # one launch a step in both generic modes: per_leaf's K4 takes every
    # leaf at once, as flat's K1 takes the pack
    steps = grown["flat"]["dane_update_flat"]
    check(grown["per_leaf"]["dane_update_2d"] == steps,
          f"per_leaf launched K4 {grown['per_leaf']['dane_update_2d']} "
          f"times in the {steps} steps flat launched K1")
    print(f"  one update launch a step in flat and per_leaf: {steps} in "
          f"2 rounds each")
    for mode in ("fused_step", "fused_epoch"):
        e = max_err(torch, finals[mode], finals["flat"])
        print(f"  |{mode} - flat| = {e:.2e}")
        check(e <= TRAJECTORY_TOL, f"{mode} departs from flat by {e}")
    print("  flat == per_leaf bitwise: yes")

    print("[6] FEMNIST-like logistic regression d=784 C=10 N=200 K=10 E=20")
    cfg = FederatedConfig(algorithm="feddane", mu=0.001,
                          **dict(PAPER, num_devices=200))
    spread, scale = cpu_sensitivity(torch, fem_cpu, cfg)
    fem_tol = SPREAD_FACTOR * spread
    print(f"  CPU path, one round: a 1e-7 nudge of w0 moves params by "
          f"{spread:.2e}; max |param| {scale:.3g}; card held to "
          f"{SPREAD_FACTOR:g} x {spread:.2e} = {fem_tol:.2e}")
    check(0 < fem_tol <= MAX_REL_LIMIT * scale,
          f"FEMNIST-like limit {fem_tol} is not inside (0, "
          f"{MAX_REL_LIMIT} x {scale}]")
    before = dict(counts)
    tr, st, phase_ms["femnist/auto"] = run_pair(
        torch, fem, fem_cpu, cfg, 3, "femnist feddane auto",
        tol=fem_tol)
    grew = _delta(before, counts)
    modes = [m for m, k in (("fused_epoch", "local_epoch"),
                            ("fused_step", "linear_logistic_step"))
             if grew.get(k)]
    print(f"    fused modes taken: {modes}  launches {grew}")
    device_share(torch, lambda: tr.round(st), "femnist feddane auto")
    before = dict(counts)
    _, _, phase_ms["femnist/fused_step"] = run_pair(
        torch, fem, fem_cpu, dataclasses.replace(cfg,
                                                 local_solver="fused_step"),
        1, "femnist feddane fused_step", tol=fem_tol)
    print(f"    launches {_delta(before, counts)}")

    int8_tol = {}
    print("[7] scenarios and lossy codecs: paper config, "
          "scenario=\"hostile\", 3 rounds per cell")
    lossy_rounds = 0
    cells = [(a, c) for a in ("feddane", "fedavg")
             for c in ("int8", "topk", "dp_gauss")] + [("feddane", "none")]
    for algo, codec_name in cells:
        cfg = FederatedConfig(algorithm=algo, mu=0.001, scenario="hostile",
                              codec=codec_name, **PAPER)
        label = f"{algo}/hostile/{codec_name}"
        tol = TRAJECTORY_TOL
        if codec_name == "int8":
            # a one-ulp difference of a rotated delta can move a code
            # across a floor boundary: hold the card to a multiple of
            # what a 1e-7 nudge of w0 does on the CPU path itself
            spread, scale = cpu_sensitivity(torch, syn_cpu, cfg, rounds=3)
            tol = SPREAD_FACTOR * spread
            print(f"  {label}: CPU path, 3 rounds: a 1e-7 nudge of w0 "
                  f"moves params by {spread:.2e}; max |param| {scale:.3g}; "
                  f"card held to {SPREAD_FACTOR:g} x {spread:.2e} = "
                  f"{tol:.2e}")
            check(0 < tol <= MAX_REL_LIMIT * scale,
                  f"{label}: limit {tol} is not inside (0, "
                  f"{MAX_REL_LIMIT} x {scale}]")
            int8_tol[algo] = tol
        before = dict(counts)
        tr, st, phase_ms[label] = run_pair(torch, syn, syn_cpu, cfg, 3,
                                           label, tol=tol)
        device_share(torch, lambda: tr.round(st), label)
        grew = _delta(before, counts)
        lossy = 4 if codec_name != "none" else 0
        lossy_rounds += lossy
        check(grew.get("codec_aggregate", 0) == lossy,
              f"{label}: {grew.get('codec_aggregate', 0)} K5 launches in "
              f"{lossy} lossy rounds")
        print(f"    launches {grew}")
    print(f"  K5 launches = lossy rounds on the card = {lossy_rounds} "
          f"(3 compared + 1 profiled per lossy cell)")

    print(f"  phases 4-7 took {time.perf_counter() - t4:.1f} s")
    print("[8] the paper's non-convex tasks: Sent140-like and "
          "Shakespeare-like LSTMs at full width, Fig. 1's settings")
    t0 = time.perf_counter()
    k1 = next(r for r in rows if r["name"] == "dane_update_flat")
    k1_cases = {
        n: next(c for c in k1["cases"] if c["shape"].startswith(
            f"dane_update_flat ({10 * n}, 128)"))
        for n in (lstm_rows(sentlstm_specs(SENT_VOCAB)),
                  lstm_rows(charlstm_specs(SHAKES_VOCAB)))}
    lstm_ms, sent140 = lstm_phase(torch, counts, k1_cases, lstm_jobs)
    phase_ms.update(lstm_ms)
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    print('[8b] the scanned driver (round_driver="scan"): one captured '
          'CUDA graph a round')
    t0 = time.perf_counter()
    phase_ms.update(scan_phase(torch, counts, syn, syn_cpu,
                               int8_tol["feddane"], sent140))
    print(f"  phase 8b took {time.perf_counter() - t0:.1f} s")

    print('[8c] the buffered driver (round_driver="buffered"): an event '
          'queue of stale clients')
    t0 = time.perf_counter()
    phase_ms.update(buffered_phase(torch, counts, syn,
                                   phase_ms["feddane/hostile/none"],
                                   sent140, buffered_jobs))
    print(f"  phase 8c took {time.perf_counter() - t0:.1f} s")

    print("[8d] the population layer: streaming client shards at "
          "N=10^6 on all three drivers")
    t0 = time.perf_counter()
    phase_ms.update(population_phase(torch, counts))
    print(f"  phase 8d took {time.perf_counter() - t0:.1f} s")

    main_path = dict(counts)             # read just after the main path

    print(f"[9] client mesh: paper config, {MESH_ROUNDS} rounds a cell")
    t0 = time.perf_counter()
    on_mesh = mesh_phase(torch, int8_tol["feddane"])
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s")

    # phases 11c-11e's CPU paths, in the pool while phases 10-11b run
    jamba_cpu = pool.submit(_pooled_train,
                            JAMBA_TRAIN_ARGV + ["--rounds", "2",
                                                "--device", "cpu"])
    xlstm_cpu = xlstm_cpu_jobs(pool)
    whisper_cpu = whisper_cpu_jobs(pool)
    print("[10] LM stack inference at full width (prefill and serve)")
    t0 = time.perf_counter()
    build.reset_launch_counts()          # the LM path starts here
    lm_ms = lm_phase(torch, counts)
    lm_path = dict(counts)               # and is read here
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: v for k, v in lm_path.items() if v} }")

    print(f"[10c] the hybrid arch at full width: jamba-v0.1-52b "
          f"({JAMBA_LAYERS} of 32 layers) through K7 and K8")
    t0 = time.perf_counter()
    build.reset_launch_counts()          # the hybrid path starts here
    lm_ms.update(jamba_phase(torch, counts))
    jamba_path = dict(counts)            # and is read here
    print(f"  phase 10c took {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: v for k, v in jamba_path.items() if v} }")

    print("[10d] xLSTM at full width and depth: xlstm-350m (24 layers) "
          "through K9 and K10")
    t0 = time.perf_counter()
    build.reset_launch_counts()          # the xLSTM path starts here
    lm_ms.update(xlstm_phase(torch, counts))
    xlstm_path = dict(counts)            # and is read here
    print(f"  phase 10d took {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: v for k, v in xlstm_path.items() if v} }")

    print("[10e] the encoder-decoder at full width and depth: whisper-tiny "
          "(4 + 4 layers) through K7")
    t0 = time.perf_counter()
    build.reset_launch_counts()          # the whisper path starts here
    lm_ms.update(whisper_phase(torch, counts))
    whisper_path = dict(counts)          # and is read here
    print(f"  phase 10e took {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: v for k, v in whisper_path.items() if v} }")

    print("[11] LM training at full width: qwen1.5-0.5b's loss, train "
          "steps, federated trainer and pods as clients")
    t0 = time.perf_counter()
    build.reset_launch_counts()          # the training path starts here
    train_out = train_phase(torch, counts)
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    print("[11b] training the MoE archs: qwen3-moe-235b-a22b at full width "
          f"({MOE_TRAIN_LAYERS} of 94 layers), both MoE archs reduced")
    t1 = time.perf_counter()
    train_out.update(moe_train_phase(torch, counts, pool))
    print(f"  phase 11b took {time.perf_counter() - t1:.1f} s")
    print(f"[11c] training the hybrid arch: jamba-v0.1-52b at full width "
          f"({JAMBA_TRAIN_LAYERS} and {JAMBA_STEP_LAYERS} of 32 layers) "
          f"through K8 and K8-bwd, and reduced")
    t1 = time.perf_counter()
    train_out.update(jamba_train_phase(torch, counts, jamba_cpu))
    print(f"  phase 11c took {time.perf_counter() - t1:.1f} s")
    train_path = dict(counts)            # and is read here
    print(f"  phases 11-11c took {time.perf_counter() - t0:.1f} s; "
          f"launches { {k: v for k, v in train_path.items() if v} }")
    print("[11d] training xLSTM: xlstm-350m at full width and depth (24 "
          "layers) through K9, K10, K9-bwd and K10-bwd, and reduced")
    t0 = time.perf_counter()
    build.reset_launch_counts()          # the xLSTM training path starts here
    train_out.update(xlstm_train_phase(torch, counts, xlstm_cpu))
    xlstm_train_path = dict(counts)      # and is read here
    print(f"  phase 11d took {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: v for k, v in xlstm_train_path.items() if v} }")
    print("[11e] training whisper-tiny at full width and depth (4 + 4 "
          "layers) through K7 and K7-bwd, and reduced")
    t0 = time.perf_counter()
    build.reset_launch_counts()          # the whisper training path starts
    train_out.update(whisper_train_phase(torch, counts, whisper_cpu))
    whisper_train_path = dict(counts)    # and is read here
    print(f"  phase 11e took {time.perf_counter() - t0:.1f} s; launches "
          f"{ {k: v for k, v in whisper_train_path.items() if v} }")

    for r in rows:
        r["launches"] = (main_path[r["name"]] + on_mesh.get(r["name"], 0)
                         + lm_path[r["name"]] + jamba_path[r["name"]]
                         + xlstm_path[r["name"]] + whisper_path[r["name"]]
                         + train_path[r["name"]]
                         + xlstm_train_path[r["name"]]
                         + whisper_train_path[r["name"]])
        check(r["launches"] > 0, f"{r['name']} not launched on the main "
                                 f"path")
    print(f"[12] done in {time.perf_counter() - t_start:.1f} s; phase "
          f"ms/round {json.dumps({k: round(v, 3) for k, v in phase_ms.items()})}; "
          f"LM {json.dumps(lm_ms)}; training {json.dumps(train_out)}")
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "cases")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def update_paths(root: str) -> dict:
    """The DANE update's cases on the checkout at ``root`` (its own
    ``src/repro_torch``, imported in this process): K1 on the synthetic
    and FEMNIST-like packs, K4 on the synthetic leaves' (rows, 128)
    views, and one local step's update in each generic solver mode over
    the synthetic model stacked on K=10 devices, one of them masked by a
    strided column of a step table as the solver hands it over:
    ``ops.dane_update_masked`` (per_leaf); ``flatpack.pack_stacked`` of w
    and g, ``ops.dane_update_flat_masked`` and ``unpack_stacked`` (flat,
    packing every step); ``ops.FlatUpdate.step`` (flat, w kept packed)
    where the checkout has it.  Each case's call ms (CUDA events around
    100 calls), device ms (a CUDA graph of 100 calls), kernels a call
    (``torch.profiler``) and a digest of its output's bits."""
    import hashlib

    import torch
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.core import pytree as pt
    from repro_torch.kernels import build, dane_update, flatpack, ops

    build.build_all(("dane_update",))
    K, C, eta, mu = 10, 10, 0.01, 0.001
    rng = np.random.default_rng(17)

    def normal(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).cuda()

    table = torch.ones(K, 4, device="cuda")
    table[3] = 0.0
    mask = table[:, 1]
    cases = {}

    def case(name, fn, out=None):
        out = fn() if out is None else out
        h = hashlib.sha256()
        for x in pt.leaves(out):
            h.update(x.contiguous().cpu().view(torch.uint8).numpy())
        cases[name] = dict(call_ms=cuda_ms(torch, fn, 100),
                           device_ms=graph_ms(torch, fn, 100),
                           kernels=kernels_per_call(torch, fn),
                           digest=h.hexdigest()[:16])

    for rows in (8, 64):
        w, g, c, a = (normal(K * rows, 128) for _ in range(4))
        case(f"K1 ({K * rows}, 128)", lambda: dane_update.dane_update_flat(
            w, g, c, a, eta, mu, mask, rows))
    for n in (K * 60 * C, K * C):
        w, g, c, a = (normal(-(-n // 128), 128) for _ in range(4))
        case(f"K4 ({w.shape[0]}, 128)",
             lambda: dane_update.dane_update_2d(w, g, c, a, eta, mu))
    wt, gt, ct = ({"w": normal(K, 60, C), "b": normal(K, C)}
                  for _ in range(3))
    w0 = {"w": normal(60, C), "b": normal(C)}
    at = pt.tmap(lambda x: x.expand((K,) + x.shape).contiguous(), w0)
    case("per_leaf step", lambda: ops.dane_update_masked(
        wt, gt, ct, at, eta, mu, mask))
    spec = flatpack.flat_spec(w0)
    corr_f = flatpack.pack_stacked(spec, ct, K)
    anchor_f = flatpack.pack_broadcast(spec, w0, K)
    case("flat step, packing w and g", lambda: flatpack.unpack_stacked(
        spec, ops.dane_update_flat_masked(
            flatpack.pack_stacked(spec, wt, K),
            flatpack.pack_stacked(spec, gt, K), corr_f, anchor_f, eta, mu,
            mask, spec.rows), K))
    if hasattr(ops, "FlatUpdate"):
        # the digest is the first step's, from the anchor
        upd = ops.FlatUpdate(spec, ct, w0, K)
        first = ops.FlatUpdate(spec, ct, w0, K).step(gt, eta, mu, mask)
        case("flat step, w kept packed",
             lambda: upd.step(gt, eta, mu, mask), out=first)
    return dict(root=root, card=smi(), cases=cases)


def update_paths_main(roots) -> int:
    """``--update-paths A B B A``: :func:`update_paths` on each checkout
    in turn, each in its own process; one JSON line each.  Equal digests
    across checkouts are bitwise-equal results."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    for root in roots or [str(ROOT)]:
        out = subprocess.run(
            [sys.executable, __file__, "--update-paths-of", root],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--update-paths"]:
        sys.exit(update_paths_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--update-paths-of"]:
        print(json.dumps(update_paths(sys.argv[2])))
        sys.exit(0)
    sys.exit(main())
