#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dlrover_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--launcher-alone]

With ``--launcher-alone`` it runs only the build, [training] and
[launcher], nothing beside the drill, and prints {"launcher": {...}} in
place of the kernels' line: the recovery_s to report.  With no argument
it builds the CUDA kernels from dlrover_tpu_torch/csrc (nvcc, at first
use), then runs, in order, failing on the first phase that fails:

1. device: the card's name and power limit, as nvidia-smi reports them;
   Then each kernel's registers and spills (nvcc -Xptxas -v) and, per
   kernel of each built library, the count of HGMMA (wgmma), UTMALDG (TMA
   load) and HMMA (mma.sync) instructions in its SASS (cuobjdump -sass).
   The D=128 instance of each flash kernel must hold wgmma and TMA loads
   and no mma.sync: all three are warp-specialised wgmma + TMA kernels
   (dQ holds a 128-row Q/dO tile and streams 128-row K/V tiles);
2. kernels vs plain versions: each flash attention kernel (forward, dQ,
   dK/dV) against its plain PyTorch version on the same inputs, at small
   shapes (causal and not, GQA 4:2, head_dim 64 and 128), at shapes off
   the 128-row tiles (S=80 below one tile, D=64, GQA 2:1, causal; S=333,
   D=64, GQA 4:1, not causal; S=200, D=128, causal; S=192, D=128, GQA
   2:1, causal: a multiple of 64 but not of 128), at S=2048, D=128,
   GQA 4:1, at the cp=2 ring's off-diagonal block (B=4, S=1024, H=16,
   D=128, not causal) and at the training shape (B=4, S=2048, H=16,
   D=128); forward
   within 3e-2 absolute
   (LSE 1e-3), gradients within 0.05 * max|plain|, and every output, on
   every tile of 64 sequence positions, within a relative error
   ||kernel - plain||_F / ||plain||_F of 1e-2.  Then a small Llama's
   logits through the flash kernels against the reference attention core;
3. kernel timing at the training shape with CUDA events, beside each
   kernel's bound on an H100 (bytes over 3.35 TB/s, bf16 operations over
   989 TFLOP/s), its plain version and F.scaled_dot_product_attention
   (timed here only, as a yardstick; the port never calls it): its
   forward beside the forward kernel, and its backward alone (the forward
   run once and kept, then torch.autograd.grad with retain_graph) beside
   the dQ and dK/dV kernels; then the same at the cp=2 ring's
   off-diagonal block (B=4, S=1024, not causal) beside SDPA's non-causal
   forward and backward;
4. training: Llama-2-1B at full width and depth (22 layers), flash
   attention, B=4, S=2048 from a seeded numpy batch, AdamW with bf16
   moments, bf16 grads on fp32 masters; one warm-up step and 9 timed
   steps (the uninterrupted run of [launcher]'s 10), each with a finite loss and the kernel launch counts a step
   must make (2 forwards per layer with remat, one dQ and one dK/dV);
   the mean, median and shortest step; then one more step under
   torch.profiler for the device time by phase and by kernel family, and
   the device's busy share of the median step;
   [flash checkpoint], on that trainer and state: the state's bytes, the
   free bytes of /dev/shm and the host's available RAM (a state that does
   not fit in /dev/shm is checkpointed at the largest depth at full width
   that does, printed as "reduced: depth N of 22"); two synchronous memory
   saves (async_snapshot=False) and their blocking times; then the
   reference bench's sequence (dlrover_tpu_torch/trainer/flash_checkpoint/
   bench.py run()): 4 steps without a save, an async memory save
   (warm-up), an async storage save (blocking_save_s), 4 steps while it
   stages and persists (persist_total_s), a restore from shm into the
   trainer's own state (restore_shm_s) and, after one more step, a restore
   from storage by a fresh scope (restore_storage_s); each restore must be
   torch.equal, leaf by leaf, to a copy taken on the card at the save, the
   model's bf16 compute copy must equal the restored masters, the flash
   launches of the phase's 9 steps must be 9 steps' worth, and a step from
   the restored state must reproduce the loss of the first step trained
   from the snapshot (1e-6 relative); last, a newer memory snapshot whose
   generation is made odd (torn) must restore the storage step.  Every
   shm segment and the checkpoint directory are released at its end, and
   its numbers go to a {"ckpt": {...}} JSON line;
   [dist persist], on the same trainer and state cut to DIST_CKPT_LAYERS
   (11) of its 22 layers (for the script's time limit; and
   further as above when /dev/shm needs it): a storage save with DLROVER_TPU_DIST_PERSIST=1
   (distributed.py; synchronous, into a fresh directory, removed after)
   must seal with bytes_written equal to the state's bytes; a second save
   of the same state, labelled the next step, must seal writing 0 bytes
   and reusing all of them; a fresh scope (no shm) restores the sealed
   step, torch.equal leaf by leaf to a copy taken at the save, and a step
   from it has the uninterrupted next step's loss (1e-6 relative) and 2
   steps' flash launches; persist seconds and GB/s, bytes_written,
   bytes_reused, restore seconds and bytes_read/bytes_total are printed
   and go to a {"dist_persist": {...}} line (the state is cut in depth
   where /dev/shm cannot hold two segments of it, for the next phase);
   [peer restore], on [dist persist]'s trainer, saved state and sealed
   commit, before they are released (peer_restore.py): the donor is its
   memory save of the sealed step (the segment of its second save),
   served by a PeerServeEndpoint on 127.0.0.1 and announced through a
   LocalPeerClient as process 1 of 2; process 0's Checkpointer, its
   segment empty, has it filled by recover() as the engine's hook does
   (rung peer_shm, every payload byte from the peer, the meta byte-equal
   to the donor's) and restores it, torch.equal leaf by leaf to the saved
   state,
   and a step from it has the uninterrupted next step's loss (1e-6
   relative) and one step's flash launches; then, the donor gone, the
   same step recovered with no donor from the sealed commit (rung
   manifest, every payload byte from it), with the same checks; mttr_s,
   peer_read_gbps, bytes_peer and bytes_manifest of each, then
   bench.peer_recovery_bench() at its default (8 MB, 4 local hosts, one
   dead), all in a {"peer_restore": {...}} line;
   [dist bench]: the reference's persist bench (dist_bench.py: hosts
   simulated in this process, 1, 2 and 4 of them, one coordinator) at 1024
   MB when the temp dir's disk and the host's RAM allow (64 MB else), its
   DIST_CKPT_BENCH line: persist GB/s by host count, the bytes a
   differential save writes against a full one, and the bytes a
   half-state read reads (0.5 of the full read);
   [telemetry], after that trainer is freed: the rank's runtime digest
   (observability/).  Every phase but this one and the dp leg's probed
   run runs with the digest's scopes off (DLROVER_TPU_MEM_SCOPE=0,
   DLROVER_TPU_JITSCOPE=0, DLROVER_TPU_DIGEST_EVERY=0), [training]
   included, so their numbers stay those of earlier runs.  Here the same
   trainer is made again from the same seed with them on (a digest every
   step into a temp dir; the flash library's loaded handle dropped first,
   so that the first watched step resolves it as a worker's first step
   does) and takes [training]'s 5 steps: losses within 1e-6 relative of
   [training]'s, flash launches 44 / 22 / 22 a step; the memory account
   in GB, the digest file's keys and values, the gp_* phases and js_*
   counters are printed, and it checks that the account sums exactly to
   the sampled used_b, that used_b is torch.cuda.memory_allocated read at
   every sample, that params are 4 B and the optimizer 2 x 2 B a
   parameter, that used <= peak <= limit with the limit mem_get_info's
   total, that collect_node_tpu_metrics(device="cuda") reads the same
   bytes in MB, and that js_hits + js_misses is the number of libraries
   the kernel build resolved in those steps.  Then 8 steps with the hooks
   on and off in turns (step ms and the host ms spent in the hooks, each),
   and 20 steps at the reference's default cadence (a digest every 20
   steps), whose hook time must stay under 1% of the step; its numbers
   go to a {"telemetry": {...}} line;
   [launcher], in a thread beside the [mesh] phase's legs of ranks (below:
   the worker's ~35 GB and the ranks' ~16 fit the card together, and the
   script keeps within its time limit): the port's standalone launcher
   (trainer/elastic_run.py: its local master, elastic agent and master
   client, over HTTP) runs the worker
   dlrover_tpu_torch/examples/train_llama_ckpt.py at llama2_1b ([training]'s
   model and recipe) through bench.recovery_drill(platform=""): the worker
   hard-crashes at step 7 (os._exit(17)) after the memory save of step 6,
   the agent persists that snapshot on the failure and restarts the
   worker in place (NodeFailureDiagnostician: "restarting workers in
   place"), and the new worker resumes from the shm snapshot and trains
   to step 10 (a disk save there).  /dev/shm (one segment of the state)
   and the temp dir's disk (two persisted steps) are checked first.  It
   fails unless the launcher exits 0; the output holds "simulating crash
   at step 7", "resumed from step 6", "done at step 10" and the blocking
   memory save of step 6 (llama2_1b's saves are synchronous: an async one
   would still be staging when the crash tears it); every step of both
   workers launched 44 / 22 / 22 flash kernels and has the loss of
   [training]'s same step bitwise (the uninterrupted run: same model,
   seed, batch and optimizer; so a restore that lost the moments or the
   schedule's count fails); and recovery_s (the crash to the first
   finished step after the restore) is printed beside the card's name
   and power limit, named recovery_s_beside_mesh_legs here, since the
   legs share the host (--launcher-alone takes it alone);
   [mesh], after that trainer is freed: one worker process started as the
   agent starts it (process_group.launch: DLROVER_TPU_PROCESS_ID=0,
   _NUM_PROCESSES=1, a 127.0.0.1 coordinator) runs bootstrap.init (which
   must initialise nothing at world 1), build_mesh(MeshConfig()) (a mesh
   of ones over a one-rank NCCL group) and Trainer(mesh=...) on the
   training phase's configuration, seed and batch, 5 steps: each loss
   within 1e-6 relative of the training phase's same step, each step's
   flash launches 44 / 22 / 22 (its counts reset before the step and read
   after it, in that process), the median step beside the training
   phase's; then a probe of whether gloo carries all_gather_into_tensor,
   reduce_scatter_tensor and all_reduce on CUDA tensors (2 ranks on the
   card; NCCL refuses two ranks on one card), printed; then ranks that
   share the card over gloo, host-staged, at full width and 1 layer
   (DP_LAYERS), global B=4, 3 steps: tp=2 (2 ranks) always, and fsdp=2 (2 ranks) and
   fsdp=2 x tp=2 (4 ranks) only if the probe found all three ops carried
   (tp=2's ranks run beside the fsdp legs' on the card, so their step
   seconds share it);
   each run's losses and grad norms equal on every rank, within 2e-4
   (losses) and 5e-4 (grad norms) relative of the same depth on one rank
   without a mesh, and its flash launches 4 / 2 / 2 per rank a step (each
   launch on the rank's local heads).  Each leg then checkpoints (/dev/shm
   checked first): every rank makes an async memory save, staged, and an
   async storage save of its local shards (dp_workers.save_and_restore),
   takes the uninterrupted next step, restores from shm and from storage
   (a fresh scope) into a fresh state, each restore torch.equal leaf by
   leaf to a copy taken on the card at the save, and steps from each: the
   loss within 1e-6 relative of the uninterrupted next step's, the flash
   launches 4 / 2 / 2; each rank's blocking_save_s, restore_shm_s and
   restore_storage_s are printed.  The fsdp=2 leg runs after
   fsdp=2 x tp=2 and then restores that leg's stored step across meshes
   and steps: loss and grad norm within 2e-4 and 5e-4 of fsdp=2 x tp=2's
   uninterrupted next step.  fsdp=2 x tp=2 checkpoints a second time
   under the distributed persist (the same checks, into a directory of
   its own): each rank's bytes_written, their sum equal to one copy of the
   state's distinct boxes, beside what the legacy persist writes; and
   fsdp=2 restores that sealed commit as well, each rank printing its
   bytes_read/bytes_total (a part: about one half);
   [moe]: the MoE Llama (models/moe.py) at llama2_1b width, 8 layers (its
   depth cut: at 22 the state alone would take ~77 GB), E=8, top-2,
   capacity factor 1.25 (C=640), flash attention, moe_loss_fn, B=4,
   S=2048, the [training] optimizer and dtypes: one warm-up and 3 timed
   steps, each with a finite loss and 8 / 8 / 8 flash launches (no
   remat); the mean, median and shortest step and tokens/s; one more
   step under torch.profiler, its device time split into the flash
   kernels, the MoE's routing, dispatch einsum, expert matmuls and
   combine einsum (each span's forward kernels and the backward of the
   ops it recorded, by autograd sequence number), the optimizer update
   and the rest, each kernel counted once; then the capacity dispatch against the dense oracle at
   full width in fp32 with capacity factor E / top_k (nothing drops),
   within 2e-5;
   [ep] and [cp]: ring attention alone on 2 gloo ranks (cp=2) at B=4,
   S=2048, H=16, D=128, causal, against reference_attention on the whole
   sequence, fp32 within 2e-3 and bf16 within 3e-2; [cp flash] op: the
   ring of flash blocks (ring_flash_attention) alone on 2 gloo ranks at
   the same shape in bf16, forward and backward, against FlashAttention
   on the whole sequence on one rank: out within 3e-2, dq, dk and dv
   within 0.05 * max|one-rank| and every tile of 64 positions within a
   relative error of 1e-2, rank r launching r + 1 forward, r + 1 dQ and
   r + 1 dK/dV kernels; the forward+backward seconds of each against
   one-rank flash's; then ranks sharing the card over gloo, full width,
   global B=4, 3 steps, 1 layer (DP_LAYERS): the MoE
   (flash) on ep=2 and dp=2 x ep=2 (4 ranks of 4 layers do not fit the
   card), the Llama with ring attention (remat on) on cp=2 and tp=2 x
   cp=2, and the flash kernels over cp: the Llama (remat on) on cp=2 and
   tp=2 x cp=2 and the MoE on cp=2 (each rank holds every expert, and
   two ranks of 4 layers do not fit); each run's losses
   and grad norms equal on every rank and within the [mesh] legs' limits
   of one rank at the same depth (the MoE; the Llama with reference
   attention for the ring, with flash for the flash legs), its flash
   launches one forward, one dQ and one dK/dV per layer per rank a step
   on ep (none through the ring), and on the flash cp legs cp rank c's
   c + 1 blocks per layer (the forward twice under remat), its step
   seconds and per-rank peak GiB;
   [gpt]: a tiny GPT's fp32 logits on the card against the same weights
   on the CPU (within 1e-4); then GPTConfig.gpt2_xl at full width and
   depth (48 layers, n_embd 1600, 25 heads of 64, vocab 50304, 1.558B
   params), B=12, S=1024 (nanoGPT's config/train_gpt2.py), seeded numpy
   tokens, the [training] optimizer and dtypes, remat: one warm-up and 4
   timed steps, each with a finite loss (the first near ln(vocab)) and no
   flash launch (the reference attends through the plain core); the
   mean, median and shortest step, tokens/s, MFU as [training] computes
   it and the peak; one more step under torch.profiler split by
   phase_split into the attention core (reference_attention under its
   span: the forward with remat's recompute, and its backward), the rest
   of forward and backward, and the optimizer update;
   [vit]: the same for a tiny ViT (a seeded head) and for ViTConfig.large
   at full width and depth (24 layers, hidden 1024, 16 heads of 64, 224^2
   images, patch 16, 197 tokens, 1000 classes), B=64 seeded normal images
   and labels, vit_loss_fn (the zero head's first loss is ln(1000)):
   images/s;
   [pp]: PipelinedLlama (models/pipeline_llama.py) at llama2_1b width cut
   to 2 layers (1 a stage), flash, S=2048, 4 microbatches, gloo ranks on
   the card, function-style steps (mesh_workers.pipeline_worker) with the
   rank legs' optimizer: pp=2 at B=4 and dp=2 x pp=2 at B=8 at once (their
   step seconds share the card), 3 steps each,
   each held against one rank's unpipelined LlamaForCausalLM with the same
   weights, batch and steps (losses within 2e-4, grad norms within 5e-4,
   equal on every rank), each rank's flash launches a step equal to the
   schedule's: 8 forwards, 4 dQ and 4 dK/dV (1 layer x 4 microbatches,
   the forward again in remat's recompute; a bubble computes nothing);
   microbatch_efficiency and each rank's step seconds;
5. ring kernels vs plain versions: the fused quantize (int8, int4) and
   dequant-accumulate (int8, int4, also in place) of the ring_pallas_q
   grad sync against their plain PyTorch versions, torch.equal (tolerance
   zero) on edge inputs: zero blocks, exact .5 ties, codes saturating at
   +-127 / +-7, negative nibbles, blocks of 256 and 512, one fused
   multiply-add rounding;
6. ring add vs plain: the exact ring_pallas hop's add kernel against its
   plain version, torch.equal, out of place and in place, at widths 1, 3,
   1000, 1024, 4097 and the dp leg's largest row (16,384,000);
7. rdma ring on one card vs plain: the one-kernel ring with W ranks as W
   groups of CTAs of one cooperative launch over OneCardWindows
   (rdma_ring_one_card).  First two calls whose peers never arrive (the
   windows skip generations, so no entry barrier completes) with a 2 s
   wait limit: the windows' check() must raise within 1.75 limits, naming
   the stage (the second call leaves at once on the broken windows), and
   a call on fresh windows must be right again; then W in {2, 4, 8} and
   widths {128, 4096, 1,000,064 (ragged: not a whole number of the
   kernel's chunks), 1,048,576}, and W=4 at 16,384,000, one set of windows
   per W, each torch.equal to its plain version; then the kernel's
   one-card path: 50 calls back to back at W=4 on one set of windows,
   cycling through three inputs of widths 1,048,576, 1,000,064 and
   262,144 (so that a read of a slot or a count left by the previous call
   would show), with the launch count read around them and every output
   equal to plain; then its time at W=4, widths 16,384,000 and 262,144
   (a 4 MB bucket's row), each beside its bound (the bytes the function
   needs: each rank's buffer read once, each row written once), its plain
   version and torch.sum(xs, 0), and the windows' bytes;
8. peer window across processes: 4 gloo ranks on the card build a
   PeerWindow (cudaMalloc windows, IPC handles exchanged with all_gather)
   and each copies a seeded row into its right neighbour's slots through
   the opened handle (copies only: no kernel waits on another process);
   each rank's slots must hold its left neighbour's row exactly;
9. the dp leg: 4 rank processes on the one card over a gloo group (the
   exchange is host-staged), Llama-2-1B at full width with its depth cut
   to 1 layer (DP_LAYERS), B=1 per rank, S=2048, bf16 grads on fp32 masters, bucket
   4 MB, transport ring_pallas_q: int8_sharded (1 warm-up and 3 timed
   steps), int4_sharded (4 steps), blockwise_sharded and exact_sharded (3
   steps each), then exact_sharded over the ring_pallas tier (3 steps), all
   from the same seeded weights.  It fails on a non-finite loss, a step-0
   loss that differs between runs, a quantized mode's loss further from
   exact_sharded's than its stated tolerance (int8 1e-4 relative, int4
   and blockwise 1e-2; the exact ring 1e-5), params that are not
   bit-identical across ranks after a step, the exact ring's resolved
   tiers other than ring and ring_pallas, or a step whose ring kernel
   launches differ from what its buckets need (a quantized step: encode =
   buckets, accumulate = buckets x 3; the exact ring: add = 3 per bucket
   whose width is a multiple of 1024; no other ring kernel, and never the
   rdma ring, which needs a card per rank) or whose flash launches differ
   from 2 forwards, one dQ and one dK/dV per layer.  The int4_sharded run
   probes its comm scope: the digest hooks at cadence 1, the
   comm probe every 2 steps with the bucket chains on, so its third step
   runs the latency and bandwidth probes over the gloo dp group and each
   bucket's reduce-scatter chain twice more (an untimed and a timed call:
   the encode and accumulate launches of that step count them), and its
   fourth step's digest carries them; each rank's fxl_dp (us) and fxb_dp
   (GB/s), each bucket's transport, width, wire bytes, chain ms and GB/s
   on every rank, all finite and > 0, and the four digest files merged by
   the port's three rules (latency the ranks' max, bandwidth their min).
   The int8_sharded run
   ends with the ranks' checkpoint of their states, residuals included,
   held as the [mesh] legs' (the steps after the restores launching the
   ring kernels as the uninterrupted step does), and again under the
   distributed persist (each rank's bytes_written and their sum, one copy
   of the distinct boxes: the masters once, the moments' quarters, the
   four residual rows); then 2 new ranks restore
   it from storage with Trainer.load_state and take one int8_sharded
   step: the step saved, the sum over the replicas of their residuals
   within 1e-6 of the saved residuals' norm of the saved sum (seeded
   projections, dp_workers.ef_digest), zero where dp=4 stored none, a
   finite loss, and the int8 encode and accumulate kernels launched as
   the new degree's buckets need;
   [replica], in the spawn of the 2 ranks of load_state above, after it:
   the dp leg's model (full width, 1 layer, B=2 per rank), one step, then
   dp_workers.lose_and_restore: a memory save, the uninterrupted next
   step, rank 1 (as its replacement would) drops its segment and its
   backup and opens a fresh checkpointer, every rank restores into a
   fresh state and steps.  The replica pass runs int8_sharded over
   ring_pallas_q with Checkpointer(replica=True): the save is synchronous
   and ends in the replica exchange (its seconds, bytes and rounds per
   rank), and rank 1 comes back from rank 0's backup through the engine's
   retry.  The peer pass runs the exact (replicated) sync with
   DLROVER_TPU_PEER_RESTORE=1: rank 1 is refilled from rank 0's endpoint
   through the broker over the world's store (rung peer_shm), rank 0
   fetches nothing.  On every rank of both passes: the saved step
   restored torch.equal, the next step's loss within 1e-6 relative, its
   flash launches a step's, its ring kernels' launches the uninterrupted
   step's (int8: encode and accumulate; none for the exact sync);
10. the ring kernels at the dp leg's largest and smallest bucket shapes:
   torch.equal against the plain versions (the JSON line's max_abs_err is
   the largest |kernel - plain| over every comparison), then time per
   launch with CUDA events beside the bound (bytes over 3.35 TB/s) and
   the plain version; the hop add at the largest row like for like, in
   turns (kernel, torch, torch, kernel): in place, as the ring runs it,
   beside torch.add(a, b, out=a) (its ``library_ms``), and out of place
   beside torch.add(a, b) (``ms_out_of_place``, ``library_ms_out_of_place``).

After the phases, and also when one fails, it stops every process it
started that is still there and prints each under ``[processes]``: the
script is the child subreaper of what it starts (so that a process
whose parent exited is still found below it), rank processes are joined
and then killed, anything else below it gets SIGTERM and then SIGKILL,
and multiprocessing's resource tracker is stopped and waited for as
multiprocessing's last exit finalizer.

The last three lines are the kernels' JSON record (each flash kernel's
with its D=128 instance's SASS counts under ``sass``), the nvidia-smi
line and ``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is
its count over the path that runs it here: the single-device training
(flash), the dp leg (the ring_pallas_q and ring_pallas kernels), and for
the rdma ring its one-card path (``launches_dp_leg`` beside it: 0, as
the dp leg's ranks share the card; its times at W = 4 at each of its two
widths under ``widths``, the first also as its ``ms``, and its windows'
bytes as ``window_bytes``); each flash kernel's
``launches_mesh`` is its count over the [mesh] phase's world-1 run,
``launches_ckpt`` over every rank's steps after the [mesh] legs'
restores, ``launches_moe`` over the [moe] phase's steps, ``launches_pp``
over every rank's steps of the [pp] legs, ``launches_cp`` a step by rank
on each flash [cp] leg, ``launches_launcher`` over both workers' steps in
the [launcher] phase (counted by each worker, read from its step lines),
``launches_peer_restore`` over the [peer restore]
phase's two steps after its restores, and ``off_diagonal`` its time,
bound, plain and SDPA times at the cp=2 ring's off-diagonal block; each
ring kernel's ``launches_load_state`` is its count over the step after
the dp leg's ``load_state`` at 2 ranks, and ``launches_comm_probe`` the
launches the dp leg's bucket chains added, over every rank; the flash and ring kernels'
``launches_replica`` over every rank's steps after the [replica] leg's
restores.  Without a CUDA device it exits 1 and prints
no result.
"""

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FWD_ATOL = 3e-2
LSE_ATOL = 1e-3
GRAD_REL = 0.05
# ||kernel - plain||_F / ||plain||_F on each tile of REL_TILE sequence
# positions, the largest over the tiles.  The max-abs limits above are set
# by the largest values (the early causal rows); this one holds every tile,
# the late rows' small values too.  bf16 rounding of the outputs alone
# gives a few 1e-3.
REL_TOL = 1e-2
REL_TILE = 64
TRAIN_B, TRAIN_S, TIMED_STEPS = 4, 2048, 4
# [launcher]: the worker crashes at step 7 of 10; [training] takes the
# 10 steps uninterrupted (one warm-up, 9 timed), and every step of both
# workers must have its loss bitwise
LAUNCHER_CRASH_STEP, LAUNCHER_STEPS = 7, 10
TRAIN_STEPS = LAUNCHER_STEPS
# (B, S, H, H_kv, D, causal) of the kernel-vs-plain checks: small shapes
# (causal and not, GQA 4:2, head_dim 64 and 128); off the 128-row tiles:
# below one tile, ragged (a multiple of neither 64 nor 128), the ragged
# last tile at D=128, and S a multiple of 64 but not of 128 (the last
# 128-row tile half past S: one of dQ's two warpgroups has no row to
# compute); S=2048 with GQA 4:1; the off-diagonal block of the ring of
# flash blocks at cp=2 (a chunk of the training sequence against an
# earlier rank's chunk: unmasked); the training shape last
CP_OFF_DIAGONAL = (TRAIN_B, TRAIN_S // 2, 16, 16, 128, False)
FLASH_SHAPES = tuple((2, 256, 4, 2, D, causal) for D in (64, 128)
                     for causal in (True, False)) + (
    (2, 80, 4, 2, 64, True), (2, 333, 8, 2, 64, False),
    (1, 200, 4, 4, 128, True), (2, 192, 4, 2, 128, True),
    (1, TRAIN_S, 16, 4, 128, True), CP_OFF_DIAGONAL,
    (TRAIN_B, TRAIN_S, 16, 16, 128, True))
SOURCE = "dlrover_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "dlrover_tpu/ops/pallas/flash_attention.py:64",
    "flash_bwd_dq": "dlrover_tpu/ops/pallas/flash_attention.py:195",
    "flash_bwd_dkv": "dlrover_tpu/ops/pallas/flash_attention.py:239",
}
# the main path's instance (D=128) of each flash kernel
SASS_KERNEL = {"flash_fwd": "fa_fwd_kernel<128>",
               "flash_bwd_dq": "fa_bwd_dq_kernel<128>",
               "flash_bwd_dkv": "fa_bwd_dkv_kernel<128>"}
RING_SOURCE = "dlrover_tpu_torch/csrc/ring_reduce_scatter.cu"
RING_REPLACES = {
    "q8_encode": "dlrover_tpu/ops/pallas/ring_reduce_scatter.py:113",
    "q4_encode": "dlrover_tpu/ops/pallas/ring_reduce_scatter.py:123",
    "q8_accum": "dlrover_tpu/ops/pallas/ring_reduce_scatter.py:141",
    "q4_accum": "dlrover_tpu/ops/pallas/ring_reduce_scatter.py:145",
}
ADD_REPLACES = "dlrover_tpu/ops/pallas/ring_reduce_scatter.py:81"
RDMA_SOURCE = "dlrover_tpu_torch/csrc/rdma_ring.cu"
RDMA_REPLACES = "dlrover_tpu/ops/pallas/ring_reduce_scatter.py:257"
# the dp leg's largest bucket row: the embedding's (32000 x 2048) / 4
DP_LARGEST_ROW = 16_384_000
ADD_WIDTHS = (1, 3, 1000, 1024, 4097, DP_LARGEST_ROW)
# 1,000,064: a multiple of 128 that is not one of the kernel's 2048-element
# chunks
RDMA_SHAPES = tuple((w, n) for w in (2, 4, 8)
                    for n in (128, 4096, 1_000_064, 1_048_576)) + (
                        (4, DP_LARGEST_ROW),)
# the reuse check's calls cycle through three inputs of these widths on one
# set of windows, as the trainer's buckets of different widths do
RDMA_REUSE_CALLS, RDMA_REUSE_WORLD = 50, 4
RDMA_REUSE_WIDTHS = (1_048_576, 1_000_064, 262_144)
# the times: the dp leg's largest row, and a 4 MB bucket's row at W = 4
RDMA_TIME_WIDTHS = (DP_LARGEST_ROW, 262_144)
# the stuck-peer check's wait limit (the windows' default is a minute)
RDMA_TIMEOUT_S = 2.0
PEER_WINDOW_WIDTH = 1_048_576
# the rank legs' depth at full width (the dp leg, [mesh], [ep], [cp] and
# [replica]): 1 layer (cut from 4, then 2) keeps the
# whole script inside its limit beside the [launcher] drill
DP_WORLD, DP_LAYERS, DP_BUCKET_MB = 4, 1, 4.0
# (run, mode, transport, steps): the schedule's lr is 0 at step 0, so a
# loss from step 2 on is the first to see an update
DP_RUNS = (("int8_sharded", "int8_sharded", "ring_pallas_q", 4),
           ("int4_sharded", "int4_sharded", "ring_pallas_q", 4),
           ("blockwise_sharded", "blockwise_sharded", "ring_pallas_q", 3),
           ("exact_sharded", "exact_sharded", "auto", 3),
           ("exact_sharded/ring_pallas", "exact_sharded", "ring_pallas", 3))
# a quantized mode's loss against exact_sharded's, relative, after one
# update of lr 3e-5 from the same weights.  int4 (and the blockwise mix,
# whose base codes are int4) zeroes every element below max/14 of its
# 256-element block, and Adam turns a changed gradient element into a
# whole-lr step: a first run of this leg measured int8 5.7e-6 and int4
# 2.2e-3 (H100, 700 W)
DP_LOSS_RTOL = {"int8": 1e-4, "int4": 1e-2, "blockwise": 1e-2}
# the exact ring against the stock reduce-scatter: the same sum in another
# order (the reference's own tolerance, tests/test_grad_overlap.py)
EXACT_RING_RTOL = 1e-5
# step 0's loss, before any update, across modes: the same forward on the
# same card, so only a nondeterministic reduction could move it
DP_STEP0_RTOL = 1e-6
DP_TIMEOUT_S = 480.0
# the dp leg's run that probes its comm scope: every digest hook at
# cadence 1, the probe every 2 steps (its third step probes after writing
# its digest, so the fourth step's digest carries the probe), each
# bucket's chain run twice a probe (BucketScope.measure(reps=1): one
# untimed call, one timed)
DP_PROBE_RUN, DP_PROBE_EVERY, DP_PROBE_CHAINS = "int4_sharded", 2, 2
# the runtime digest's scopes, off in every phase but [telemetry] and the
# dp leg's probed run, so that those measure what they did before
SCOPES_OFF = {"DLROVER_TPU_MEM_SCOPE": "0", "DLROVER_TPU_JITSCOPE": "0",
              "DLROVER_TPU_DIGEST_EVERY": "0"}
SCOPES_ON = {"DLROVER_TPU_MEM_SCOPE": "1", "DLROVER_TPU_JITSCOPE": "1",
             "DLROVER_TPU_DIGEST_EVERY": "1"}
# [telemetry]: the hooks on and off in turns, a step each; then steps at
# the reference's default digest cadence, whose hook time a step must stay
# under 1% of the step (the reference's budget for its flight recorder)
TELEMETRY_TURNS = ("on", "off", "off", "on", "on", "off", "off", "on")
TELEMETRY_DEFAULT_EVERY, TELEMETRY_HOOK_SHARE = 20, 0.01
TELEMETRY_LOSS_RTOL = 1e-6
# [dist bench]: the payload of the reference's persist bench (8 leaves)
DIST_BENCH_MB = 1024
# [flash checkpoint]: steps without a save, and steps trained while the
# snapshot stages; bytes of the segment's meta on top of the state's
CKPT_STEPS = 4
CKPT_META_MARGIN = 64 << 20
# the depth [dist persist] and [peer restore] checkpoint at: llama2_1b cut
# from 22 layers to keep the script within its time limit beside the
# [launcher] drill (their rates per byte stay comparable)
DIST_CKPT_LAYERS = 11
# the forward of the step from the restored state against the first step
# from the snapshot: the same weights, batch and kernels on one card
RESTORED_LOSS_RTOL = 1e-6
# [mesh]: steps of the world-1 run, and its losses against [training]'s
# first: a mesh of ones places nothing, so the step is the plain path's
MESH_STEPS = 1 + TIMED_STEPS
MESH_LOSS_RTOL = 1e-6
# the ranks that share the card ([mesh], [ep] and [cp]): steps, depth
# (the dp leg's), and the losses and grad norms of a split model against
# the same depth on one rank (bf16: a tp=2 row shard sums two bf16
# partial outputs where one rank sums in fp32 and rounds once; fsdp
# reduces the bf16 gradients in fp32; ep sums the experts' bf16 partial
# outputs over ranks; ring attention keeps fp32 probabilities where the
# one-rank reference core rounds them to bf16).  Step 0 runs at lr 0, so
# its grad norm is the gradient of the same weights on one rank and on
# the mesh: a gradient off by a factor shows there.  Runs of these legs
# measured losses within tp=2 2.1e-6, fsdp=2 1.4e-5, fsdp=2 x tp=2
# 2.6e-5, ep=2 1.5e-6, dp=2 x ep=2 1.8e-5, cp=2 1.9e-5 and tp=2 x cp=2
# 2.7e-5, and grad norms within 5.6e-5 to 9.3e-5 (tp=2 x cp=2) (H100,
# 700 W; PERF.md)
MESH_RANK_STEPS = 3
MESH_RANK_RTOL = 2e-4
MESH_RANK_NORM_RTOL = 5e-4
MESH_TIMEOUT_S = 600.0
# the checkpoint of the ranks' legs: bytes of /dev/shm a rank leg's state
# takes per parameter (fp32 masters, two bf16 moments), and a dp rank's
# (fp32 masters and residuals, its ZeRO-1 quarter of the moments), beside
# each segment's meta
MESH_CKPT_BYTES_PER_PARAM = 8
DP_CKPT_BYTES_PER_PARAM = 9
# the dp leg's restore at a smaller dp degree (Trainer.load_state), and
# the sum over the replicas of its error-feedback residuals against the
# sum saved (fp32 rows summed in numpy and halved: rounding only)
DP_RESUME_WORLD = 2
# [replica]: ranks (those of the dp leg's load_state, whose spawn runs it)
# and steps before the memory save
REPLICA_WORLD, REPLICA_STEPS = DP_RESUME_WORLD, 1
EF_SUM_RTOL = 1e-6
# [moe]: the MoE Llama at llama2_1b width, its depth cut to 8 layers (at
# 22 its state alone would take ~77 GB of the 80); steps after warm-up
MOE_LAYERS, MOE_TIMED_STEPS = 8, 3
# the dispatch against the dense oracle with nothing dropped, fp32:
# tests/test_moe.py:53's tolerance
MOE_ORACLE_ATOL = 2e-5
# [cp]: ring attention against the reference core: fp32 as
# tests/test_ops.py holds the reference's ring (2e-3); bf16 as the flash
# forward against its plain version (the reference rounds the
# probabilities to bf16, the ring keeps them fp32)
RING_ATOL = {"float32": 2e-3, "bfloat16": FWD_ATOL}
# [cp flash] op: timed forward-and-backward calls of the ring of flash
# blocks (and of one-rank flash on the whole sequence)
RING_FLASH_ITERS = 5
# [gpt]: GPTConfig.gpt2_xl at full width and depth; B and S are nanoGPT's
# config/train_gpt2.py batch_size and block_size (the reference's
# canonical demo job)
GPT_B, GPT_S = 12, 1024
# [vit]: ViTConfig.large at full width and depth, B seeded normal images
VIT_B = 64
# a tiny model's fp32 logits on the card against the same weights on the
# CPU: one function, only the summation order differs (no TF32)
CARD_CPU_ATOL = 1e-4
PP_LAYERS = 2
# [pp]: llama2_1b width cut to PP_LAYERS layers (1 a stage on pp=2), S =
# TRAIN_S, PP_MICROBATCHES microbatches; the legs' global batch (pp=2 at
# B=4, dp=2 x pp=2 at B=8)
PP_MICROBATCHES = 4
PP_LEGS = (("pp2", dict(dp=1, pp=2), 2, TRAIN_B),
           ("dp2_pp2", dict(dp=2, pp=2), 4, 2 * TRAIN_B))


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def kernel_label(mangled: str):
    """``name<arg>`` of a mangled kernel name (its length-prefixed
    identifier ending in ``_kernel``, then its first template argument)."""
    for i in range(len(mangled)):
        for j in range(i + 1, min(i + 4, len(mangled)) + 1):
            if not mangled[i:j].isdigit():
                break
            name = mangled[j:j + int(mangled[i:j])]
            if name.endswith("_kernel") and name.isidentifier():
                arg = re.match(r"IL[ib](\d+)E", mangled[j + len(name):])
                return name + (f"<{arg.group(1)}>" if arg else "")
    return mangled


def sass_counts(_build, library) -> dict:
    """{kernel<D>: {op: count}} over the SASS of one built library."""
    from pathlib import Path

    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(library)],
        capture_output=True, text=True, check=True, timeout=120).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = kernel_label(line.split("Function :")[1].strip())
            counts[kernel] = {op: 0 for op in SASS_OPS}
        elif kernel:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    counts[kernel][op] += 1
    return counts


def print_build_report(log: str) -> None:
    """Each kernel's registers and spills from nvcc's -Xptxas -v report."""
    kernel = None
    for line in log.splitlines():
        found = re.search(r"((?:fa_\w+?|encode|accum|add|rdma_ring)_kernel)"
                          r"(?:IL[ib](\d+)E)?", line)
        if "Compiling entry function" in line and found:
            kernel = found.group(1) + (f"<{found.group(2)}>"
                                       if found.group(2) else "")
        elif kernel and ("registers" in line or "spill" in line):
            print(f"  {kernel}: {line.split(':', 1)[-1].strip()}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def descendant_pids() -> list:
    """The pids of the live processes below this one, from /proc."""
    parent = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    stat = f.read()
            except OSError:  # gone since the listing
                continue
            # the command name may hold spaces: the fields after its ")"
            parent[int(entry)] = int(stat[stat.rfind(")") + 2:].split()[1])
    below, level = [], {os.getpid()}
    while level:
        level = {pid for pid, ppid in parent.items() if ppid in level}
        below += sorted(level)
    return below


def command_of(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")[:160]
    except OSError:
        return "(gone)"


def adopt_orphans() -> None:
    """Make this process the child subreaper of what it starts (Linux
    prctl PR_SET_CHILD_SUBREAPER): a process whose parent exits is then
    reparented here, not to init, so that stop_processes still finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def stop_resource_tracker() -> None:
    """Stop multiprocessing's resource tracker and wait for it.  The spawn
    context's queues start it as a child of this process, and it would
    otherwise outlive the script until it sees its pipe close."""
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()


def stop_processes(grace_s: float = 30.0) -> None:
    """Stop every process this script started that is still there, and
    print each one: rank processes are joined, then killed; anything else
    below this process gets SIGTERM, then SIGKILL.  multiprocessing's
    resource tracker is left to the end: it is stopped as multiprocessing's
    last exit finalizer, after the semaphores' own finalizers have
    unregistered them (stopped earlier, it would unlink live ones)."""
    import multiprocessing
    import signal
    from multiprocessing import util

    gc.collect()  # dropped queues unregister their semaphores now
    stopped = []
    for p in multiprocessing.active_children():
        p.join(timeout=grace_s)
        if p.is_alive():
            stopped.append(f"{p.pid} {p.name} (killed)")
            p.kill()
            p.join(timeout=grace_s)
    util.Finalize(None, stop_resource_tracker, exitpriority=-(1 << 30))
    tracker = resource_tracker_pid()
    left = [pid for pid in descendant_pids() if pid != tracker]
    stopped += [f"{pid} {command_of(pid)}" for pid in left]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace_s
        while left and time.monotonic() < deadline:
            for pid in left:  # reap this process's own children
                try:
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass
            left = [pid for pid in left if pid in descendant_pids()]
            time.sleep(0.1)
    if tracker:
        stopped.append(f"{tracker} multiprocessing's resource tracker "
                       "(stopped at exit)")
    print(f"[processes] {len(stopped)} left by the phases"
          + "".join(f"\n  {s}" for s in stopped), flush=True)
    if left:
        raise RuntimeError(f"processes {left} outlived SIGKILL by {grace_s} s")


def resource_tracker_pid():
    from multiprocessing import resource_tracker

    return resource_tracker._resource_tracker._pid


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand_qkv(gen, B, S, H, H_kv, D):
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    return rnd(B, S, H, D), rnd(B, S, H_kv, D), rnd(B, S, H_kv, D), \
        rnd(B, S, H, D)


def check_kernels(fa, gen, B, S, H, H_kv, D, causal):
    """Each kernel against its plain version; returns, per kernel, its
    largest absolute error, that error's limit and its relative error."""
    import torch

    q, k, v, do = rand_qkv(gen, B, S, H, H_kv, D)
    out, lse = fa.flash_forward(q, k, v, causal)
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal)
    delta = fa.attention_delta(ref_out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
    torch.cuda.synchronize()
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                            causal)

    def compare(got, want, atol):
        # sequence positions are dim 1 of [B, S, H, D] and of [B*H, S]
        diff, want = got.float() - want.float(), want.float()
        rel = max((d.norm() / w.norm()).item() for d, w in zip(
            diff.split(REL_TILE, dim=1), want.split(REL_TILE, dim=1)))
        return diff.abs().max().item(), atol, rel

    def grad_tol(ref):
        return GRAD_REL * max(1.0, ref.float().abs().max().item())

    errors = {
        "flash_fwd": compare(out, ref_out, FWD_ATOL),
        "flash_fwd_lse": compare(lse, ref_lse, LSE_ATOL),
        "flash_bwd_dq": compare(dq, ref_dq, grad_tol(ref_dq)),
        "flash_bwd_dk": compare(dk, ref_dk, grad_tol(ref_dk)),
        "flash_bwd_dv": compare(dv, ref_dv, grad_tol(ref_dv)),
    }
    shape = f"B={B} S={S} H={H} H_kv={H_kv} D={D} causal={causal}"
    for name, (e, tol, rel) in errors.items():
        print(f"  {shape} {name}: max_abs_err={e:.3e} tol={tol:.3e} "
              f"rel_err={rel:.3e} rel_tol={REL_TOL:.0e}")
        if not (e <= tol and rel <= REL_TOL):
            raise AssertionError(
                f"{name} disagrees with its plain version at {shape}: "
                f"max abs {e} (tol {tol}), relative {rel} (tol {REL_TOL})")
    dk_e, dv_e = errors["flash_bwd_dk"], errors["flash_bwd_dv"]
    return {
        "flash_fwd": errors["flash_fwd"],
        "flash_bwd_dq": errors["flash_bwd_dq"],
        "flash_bwd_dkv": (*max(dk_e[:2], dv_e[:2], key=lambda x: x[0] / x[1]),
                          max(dk_e[2], dv_e[2])),
    }


def check_model_logits():
    """A small Llama on the card: logits through the flash kernels against
    the reference attention core (same weights, bf16 compute)."""
    import torch

    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)
    flash = LlamaForCausalLM(LlamaConfig(attention_impl="flash", **base),
                             device="cuda", seed=1)
    ref = LlamaForCausalLM(LlamaConfig(attention_impl="reference", **base),
                           device="cuda", seed=1)
    ids = torch.randint(0, 512, (2, 256), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
    with torch.no_grad():
        got, want = flash(ids), ref(ids)
    e = (got - want).abs().max().item()
    # two bf16 paths that round probabilities at different points; the
    # CPU tests bound bf16 model drift by 1e-1 on O(1) logits the same way
    print(f"  small llama logits, flash vs reference: max_abs_err={e:.3e} "
          f"tol=1.000e-01 shape={tuple(got.shape)}")
    if not (torch.isfinite(got).all() and e <= 1e-1):
        raise AssertionError("flash logits disagree with the reference")


def attention_work(B, S, H, D, causal):
    """(score pairs, bytes of one [B,S,H,D] bf16 tensor, bytes of one
    [B*H,S] fp32 residual)."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    return pairs, B * S * H * D * 2, B * H * S * 4


def bound_ms(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_kernels(fa, gen, S=TRAIN_S, causal=True):
    """Each flash kernel at B=4, ``S``, H=16, D=128 (``causal``) with CUDA
    events, beside its bound, its plain version and SDPA."""
    import torch
    import torch.nn.functional as F

    B, H, D = TRAIN_B, 16, 128
    q, k, v, do = rand_qkv(gen, B, S, H, H, D)
    out, lse = fa.flash_forward(q, k, v, causal)
    delta = fa.attention_delta(out, do)
    pairs, t_bytes, r_bytes = attention_work(B, S, H, D, causal)
    runs = {
        # name: (kernel, plain, flops, bytes read + written)
        "flash_fwd": (
            lambda: fa.flash_forward(q, k, v, causal),
            lambda: fa.flash_forward_plain(q, k, v, causal),
            4 * D * pairs, 4 * t_bytes + r_bytes),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
            6 * D * pairs, 5 * t_bytes + 2 * r_bytes),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal),
            8 * D * pairs, 6 * t_bytes + 2 * r_bytes),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                               is_causal=causal),
        iters=20)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg,
                                       is_causal=causal).backward(dot)

    sdpa_fwd_bwd_ms = cuda_time_ms(sdpa_fwd_bwd, iters=10)
    # the backward alone: one forward kept, its graph walked again per call
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    sdpa_bwd_ms = cuda_time_ms(
        lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dot,
                                    retain_graph=True), iters=10)
    library = {"flash_fwd": (sdpa_fwd_ms, "SDPA forward"),
               "flash_bwd_dq": (sdpa_bwd_ms, "SDPA backward alone (dQ, dK "
                                "and dV together)"),
               "flash_bwd_dkv": (sdpa_bwd_ms, "SDPA backward alone (dQ, dK "
                                 "and dV together)")}
    timings = {}
    for name, (kernel, plain, flops, nbytes) in runs.items():
        ms = cuda_time_ms(kernel, iters=20)
        plain_ms = cuda_time_ms(plain, iters=3, warmup=1)
        b_ms, b_by = bound_ms(flops, nbytes)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=library[name][0],
                             library_call=library[name][1])
        print(f"  {name}: {ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}, "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)  "
              f"plain {plain_ms:.4f} ms")
    print(f"  F.scaled_dot_product_attention(is_causal={causal}): forward "
          f"{sdpa_fwd_ms:.4f} ms, backward alone {sdpa_bwd_ms:.4f} ms, "
          f"forward+backward {sdpa_fwd_bwd_ms:.4f} ms; port dQ+dK/dV "
          f"{timings['flash_bwd_dq']['ms'] + timings['flash_bwd_dkv']['ms']:.4f}"
          f" ms, forward+dQ+dK/dV "
          f"{sum(t['ms'] for t in timings.values()):.4f} ms")
    return timings


def train_subject():
    """[training]'s model, trainer, state and batch, from seed 0: the
    llama2_1b preset with flash attention, the bf16-moment optimizer, bf16
    grads on fp32 masters; and the flash launches a step must make."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    cfg = LlamaConfig.llama2_1b(max_seq_len=TRAIN_S, attention_impl="flash")
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    trainer = Trainer(
        model,
        create_optimizer(peak_lr=3e-4, warmup_steps=10, total_steps=10_000,
                         moment_dtype=torch.bfloat16),
        grads_dtype=torch.bfloat16, device="cuda",
    )
    state = trainer.create_state()
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(TRAIN_B, TRAIN_S + 1))
    batch = {"input_ids": ids[:, :-1].astype(np.int32),
             "labels": ids[:, 1:].astype(np.int32)}
    per_step = {"flash_fwd": 2 * cfg.num_layers,
                "flash_bwd_dq": cfg.num_layers,
                "flash_bwd_dkv": cfg.num_layers}
    return cfg, trainer, state, batch, per_step, model.num_params()


def train(fa):
    import torch

    cfg, trainer, state, batch, per_step, n_params = train_subject()
    print(f"  llama2_1b: {n_params / 1e9:.3f}B params, {cfg.num_layers} "
          f"layers, hidden {cfg.hidden_size}, heads {cfg.num_heads}x"
          f"{cfg.head_dim}, vocab {cfg.vocab_size}; B={TRAIN_B} S={TRAIN_S}")
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    torch.cuda.synchronize()
    fa.reset_launches()
    for step in range(TRAIN_STEPS):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        grown = {k: fa.launches[k] - before[k] for k in per_step}
        print(f"  step {step}{' (warm-up)' if step == 0 else ''}: "
              f"loss={loss:.4f} grad_norm={grad_norm:.4f} "
              f"{dt * 1e3:.1f} ms launches={grown}")
        if not math.isfinite(loss) or not math.isfinite(grad_norm):
            raise AssertionError(f"non-finite loss/grad_norm at step {step}")
        if grown != per_step:
            raise AssertionError(f"step {step} launched {grown}, expected "
                                 f"{per_step}")
        if step == 0 and abs(loss - math.log(cfg.vocab_size)) > 2.0:
            # random weights and tokens: the loss starts near ln(vocab)
            raise AssertionError(f"first loss {loss} is far from "
                                 f"ln({cfg.vocab_size})")
        losses.append(loss)
        if step:
            step_s.append(dt)
    mean_s = sum(step_s) / len(step_s)
    # the host's clock can stall one step for hundreds of ms: the median
    # is what the profiled step's busy share is read against
    median_s = statistics.median(step_s)
    state = profile_step(trainer, state, batch, fa, per_step, median_s)
    launches = dict(fa.launches)
    tokens = TRAIN_B * TRAIN_S
    L, h = cfg.num_layers, cfg.num_heads * cfg.head_dim
    flops_per_step = (6 * n_params + 6 * L * h * TRAIN_S) * tokens
    print(f"  step_ms={mean_s * 1e3:.2f} (mean of {len(step_s)}; median "
          f"{median_s * 1e3:.2f}; min {min(step_s) * 1e3:.2f}) "
          f"tokens_per_s={tokens / mean_s:.0f}"
          f" mfu={flops_per_step / mean_s / PEAK_BF16_FLOPS:.4f} "
          f"[(6N + 6*L*h*S)*tokens / 989e12, remat not counted] "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    plain = {"loss": losses, "median_s": median_s}
    return launches, trainer, state, batch, plain


def profile_step(trainer, state, batch, fa, per_step, step_s):
    """One more step under torch.profiler: the device's busy share of the
    step, device time by phase and by kernel family, the top kernels."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    before = dict(fa.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = trainer.train_step(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
    grown = {k: fa.launches[k] - before[k] for k in per_step}
    if grown != per_step:
        raise AssertionError(f"profiled step launched {grown}")
    # device-side events, less the GPU images of the trainer's spans
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not is_span(e.name)]
    if not kernels:
        raise AssertionError("the profiler saw no device activity")
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    families = collections.Counter()
    for name, ms in by_name.items():
        low = name.lower()
        if "fa_fwd_kernel" in low:
            families["flash_fwd kernel"] += ms
        elif "fa_bwd_dq_kernel" in low:
            families["flash_bwd_dq kernel"] += ms
        elif "fa_bwd_dkv_kernel" in low:
            families["flash_bwd_dkv kernel"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma")):
            families["cuBLAS matmul"] += ms
        else:
            families["other (elementwise, reductions, copies)"] += ms
    busy_ms = sum(by_name.values())
    phases, loose = collections.Counter(), collections.Counter()
    for (phase, part, _), ms in phase_split(prof, busy_ms).items():
        phases[phase] += ms
        if phase == "unattributed":
            loose[part] += ms
    print(f"  profiled step: device busy {busy_ms:.1f} ms = "
          f"{busy_ms / (step_s * 1e3):.3f} of the {step_s * 1e3:.1f} ms "
          f"median step"
          f" (idle share {1 - busy_ms / (step_s * 1e3):.3f})")
    print(f"    forward {phases['forward']:.1f} ms, backward with remat "
          f"recompute {phases['backward']:.1f} ms, optimizer update "
          f"{phases['update']:.1f} ms, outside the step's spans "
          f"{phases['other']:.1f} ms, launched by ops the trace does not "
          f"nest {phases['unattributed']:.1f} ms "
          f"{[(n, round(ms, 2)) for n, ms in loose.most_common(3)]}")
    for family, ms in families.most_common():
        print(f"    {family}: {ms:.1f} ms ({ms / busy_ms:.3f} of busy)")
    for name, ms in by_name.most_common(8):
        print(f"    top kernel {ms:8.2f} ms  {name[:100]}")
    return state


def telemetry_phase(fa, plain) -> dict:
    """[telemetry]: [training]'s trainer again from the same seed, with
    the rank's runtime digest on (module docstring).  Returns its
    numbers."""
    import shutil
    import tempfile

    import torch

    from dlrover_tpu_torch.common import metric
    from dlrover_tpu_torch.observability import (
        flight_recorder,
        goodput,
        jitscope,
        memscope,
    )
    from dlrover_tpu_torch.ops.cuda import _build
    from dlrover_tpu_torch.parallel.dp_workers import env

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="telemetry_")
    path = os.path.join(root, "runtime_metrics.json")
    on = dict(SCOPES_ON, DLROVER_TPU_RUNTIME_METRICS_PATH=path)
    device = torch.device("cuda", torch.cuda.current_device())
    reads, resolved = [], []

    def reader():
        # the scope's own source, and the allocator's count read with it
        stats = memscope.device_mem_stats(device)
        reads.append((stats[0]["used_b"],
                      float(torch.cuda.memory_allocated(device))))
        return stats

    def listener(name, cached, seconds):
        resolved.append((name, cached, seconds))

    trainer = state = None
    try:
        with env(on):
            jitscope.install()
            jitscope.reset_scope()
            memscope.reset_scope(stats_reader=reader)
            goodput.reset_ledger()
            flight_recorder.recorder().reset()
            _build.add_listener(listener)
            # a worker resolves its kernel library inside its first step;
            # this process loaded the flash library phases ago, so its
            # handle is dropped: the first watched step resolves it again
            fa._lib = None
            _build._libs.pop(fa.KERNEL_SOURCE, None)
            cfg, trainer, state, batch, per_step, n_params = train_subject()
            losses = []
            for step in range(1 + TIMED_STEPS):
                before = dict(fa.launches)
                state, metrics = trainer.train_step(state, batch)
                losses.append(metrics["loss"].item())
                torch.cuda.synchronize()
                grown = {k: fa.launches[k] - before[k] for k in per_step}
                if grown != per_step:
                    raise AssertionError(f"[telemetry] step {step} launched "
                                         f"{grown}, expected {per_step}")
            _build.remove_listener(listener)
            with open(path + ".rank0") as f:
                digest = json.load(f)
            account = memscope.scope().account()
            sample = memscope.scope().sample()
            node = metric.collect_node_tpu_metrics(device="cuda")
        want = plain["loss"][:len(losses)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        print(f"  losses with the hooks on {[round(v, 6) for v in losses]}; "
              f"[training]'s {[round(v, 6) for v in want]}; max "
              f"rel {rel:.2e}")
        if rel > TELEMETRY_LOSS_RTOL:
            raise AssertionError(f"[telemetry] losses {rel:.2e} relative "
                                 "from [training]'s")
        subs, used = account["subsystems"], account["used_b"]
        gb = {k: round(v / 1e9, 3) for k, v in dict(
            subs, used=used, peak=account["peak_b"],
            limit=account["limit_b"],
            headroom=account["headroom_b"]).items()}
        print(f"  account GB: {gb}")
        print(f"  digest file ({len(digest)} keys): "
              f"{json.dumps(digest, sort_keys=True)}")
        print(f"  gp_*: {({k: v for k, v in digest.items() if k.startswith('gp_')})}")
        print(f"  js_*: {({k: v for k, v in digest.items() if k.startswith('js_')})}; "
              f"libraries resolved in the watched steps: {resolved}")
        checks = {
            "the account sums to used_b": account["account_sum_b"] == used,
            "the digest's subsystems sum to mm_used_b": digest["mm_used_b"]
            == sum(digest["mms_" + k] for k in memscope.SUBSYSTEMS),
            "used_b is memory_allocated at every sample": reads and all(
                u == a for u, a in reads),
            "params are 4 B a parameter": subs["params"] == 4.0 * n_params,
            "the optimizer is 2 x 2 B a parameter":
            subs["optimizer"] == 4.0 * n_params,
            "used <= peak <= limit":
            used <= account["peak_b"] <= account["limit_b"],
            "limit_b is mem_get_info's total":
            account["limit_b"] == float(torch.cuda.mem_get_info(device)[1]),
            "js_hits + js_misses = the libraries resolved":
            digest["js_hits"] + digest["js_misses"] == len(resolved) >= 1,
            "the node metric reads the same bytes, in MB": len(node.chips)
            == torch.cuda.device_count() and any(
                c.chip_id == device.index
                and c.hbm_used_mb == sample["chips"][0]["used_b"] / 2**20
                and c.hbm_total_mb == sample["chips"][0]["limit_b"] / 2**20
                and c.hbm_peak_mb == sample["chips"][0]["peak_b"] / 2**20
                for c in node.chips),
        }
        print(f"  node metric: {node.to_list()}")
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"[telemetry] failed: {failed}")
        # the hooks on and off in turns, one step each
        times = {"on": [], "off": []}
        hooks = {"on": [], "off": []}
        for turn in TELEMETRY_TURNS:
            with env(on if turn == "on" else SCOPES_OFF):
                hooked = trainer.telemetry_s
                t0 = time.perf_counter()
                state, metrics = trainer.train_step(state, batch)
                metrics["loss"].item()
                torch.cuda.synchronize()
                times[turn].append(time.perf_counter() - t0)
                hooks[turn].append(trainer.telemetry_s - hooked)
        # the reference's default cadence: one digest every 20 steps
        with env(dict(on, DLROVER_TPU_DIGEST_EVERY=str(
                TELEMETRY_DEFAULT_EVERY))):
            hooked = trainer.telemetry_s
            t0 = time.perf_counter()
            for _ in range(TELEMETRY_DEFAULT_EVERY):
                state, metrics = trainer.train_step(state, batch)
            metrics["loss"].item()
            torch.cuda.synchronize()
            default_step = (time.perf_counter() - t0) / TELEMETRY_DEFAULT_EVERY
            default_hook = ((trainer.telemetry_s - hooked)
                            / TELEMETRY_DEFAULT_EVERY)
        med = {k: statistics.median(v) for k, v in times.items()}
        share = default_hook / default_step
        print(f"  in turns {TELEMETRY_TURNS}: step ms on "
              f"{[round(t * 1e3, 2) for t in times['on']]} (median "
              f"{med['on'] * 1e3:.2f}), off "
              f"{[round(t * 1e3, 2) for t in times['off']]} (median "
              f"{med['off'] * 1e3:.2f}); host ms in the hooks a step: on "
              f"{[round(t * 1e3, 3) for t in hooks['on']]}, off "
              f"{[round(t * 1e3, 3) for t in hooks['off']]}")
        print(f"  at the default cadence (a digest every "
              f"{TELEMETRY_DEFAULT_EVERY} steps): {default_step * 1e3:.2f} ms "
              f"a step, {default_hook * 1e3:.4f} ms of it in the hooks "
              f"({share:.5f} of the step; budget {TELEMETRY_HOOK_SHARE})")
        if share >= TELEMETRY_HOOK_SHARE:
            raise AssertionError(f"[telemetry] hooks take {share:.4f} of a "
                                 "step at the default cadence")
    finally:
        _build.remove_listener(listener)
        shutil.rmtree(root, ignore_errors=True)
        memscope.reset_scope()
        jitscope.reset_scope()
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"  [telemetry] took {seconds:.1f} s", flush=True)
    return dict(losses=losses, max_rel=rel, account=gb,
                step_ms_on=[t * 1e3 for t in times["on"]],
                step_ms_off=[t * 1e3 for t in times["off"]],
                hook_ms_on=[t * 1e3 for t in hooks["on"]],
                hook_ms_off=[t * 1e3 for t in hooks["off"]],
                default_step_ms=default_step * 1e3,
                default_hook_ms=default_hook * 1e3, hook_share=share,
                js={k: v for k, v in digest.items() if k.startswith("js_")},
                seconds=seconds)


def mesh_spec() -> dict:
    """[mesh]'s model and data (``dp_workers.train_worker``'s spec): the
    [training] configuration, seed and batch."""
    import numpy as np
    import torch

    ids = np.random.default_rng(0).integers(0, 32000,
                                            size=(TRAIN_B, TRAIN_S + 1))
    return dict(
        preset="llama2_1b",
        model=dict(attention_impl="flash", max_seq_len=TRAIN_S),
        state_dict=None, seed=0,
        batch={"input_ids": ids[:, :-1].astype(np.int32),
               "labels": ids[:, 1:].astype(np.int32)},
        optimizer=dict(peak_lr=3e-4, warmup_steps=10, total_steps=10_000,
                       moment_dtype=torch.bfloat16),
        grads_dtype=torch.bfloat16)


def mesh_phase(plain):
    """The [mesh] phase: the worker bootstrap, the mesh and the mesh path
    of the Trainer, and the flash checkpoint of the ranks' legs (module
    docstring).  Returns the flash launches of the world-1 run, and the
    ranks' legs to run (``rank_legs``, which returns the flash launches of
    the steps after the legs' restores)."""
    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.parallel import mesh_workers, process_group

    spec = dict(mesh_spec(), runs=[
        dict(name="world1", axes=dict(dp=-1), steps=MESH_STEPS)])
    t0 = time.perf_counter()
    (worker,) = process_group.launch(mesh_workers.bootstrap_worker, 1,
                                     (spec,), timeout_s=MESH_TIMEOUT_S)
    rec = worker["train"]["runs"]["world1"]
    ctx = worker["context"]
    print(f"  one worker as the agent starts it (process {ctx['process_id']}"
          f" of {ctx['num_processes']}, coordinator "
          f"{ctx['coordinator_addr']}): bootstrap.init initialised "
          f"{'a group' if worker['initialised_by_init'] else 'nothing'}; "
          f"build_mesh gave a {worker['backend']} group of "
          f"{worker['world']} and the mesh {rec['shape']}; "
          f"{time.perf_counter() - t0:.1f} s with the process and model "
          "set-up", flush=True)
    if worker["backend"] != "nccl" or worker["initialised_by_init"]:
        raise AssertionError("a world of one on the card must initialise "
                             "nothing in bootstrap.init and give the mesh a "
                             "one-rank NCCL group")
    if set(rec["shape"].values()) != {1}:
        raise AssertionError(f"mesh {rec['shape']}: expected all ones")
    if len(rec["loss"]) != MESH_STEPS:
        raise AssertionError(f"{len(rec['loss'])} mesh steps, expected "
                             f"{MESH_STEPS}")
    layers = LlamaConfig.llama2_1b().num_layers
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
                "flash_bwd_dkv": layers}
    launches = dict.fromkeys(per_step, 0)
    for step, (loss, want, counts) in enumerate(zip(
            rec["loss"], plain["loss"], rec["flash_launches"])):
        rel = abs(loss - want) / abs(want)
        print(f"  step {step}: loss={loss:.6f} plain path {want:.6f} "
              f"(rel {rel:.2e}) {rec['step_s'][step] * 1e3:.1f} ms "
              f"launches={counts}")
        if not math.isfinite(loss) or rel > MESH_LOSS_RTOL:
            raise AssertionError(f"mesh step {step}: loss {loss} against "
                                 f"the plain path's {want} (tol "
                                 f"{MESH_LOSS_RTOL})")
        if counts != per_step:
            raise AssertionError(f"mesh step {step} launched {counts}, "
                                 f"expected {per_step}")
        for k in launches:
            launches[k] += counts[k]
    median_ms = statistics.median(rec["step_s"][1:]) * 1e3
    print(f"  median step {median_ms:.2f} ms (steps 1-{MESH_STEPS - 1}) "
          f"against [training]'s {plain['median_s'] * 1e3:.2f} ms; peak "
          f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB", flush=True)

    probe = process_group.spawn(mesh_workers.collective_probe_worker, 2,
                                backend="gloo", device="cuda",
                                timeout_s=120.0)
    fsdp_ok = all(v == "ok" for r in probe for v in r.values())
    print(f"  gloo probe, 2 ranks on the card, CUDA tensors: {probe[0]} "
          f"(rank 1 {probe[1]}); the fsdp legs "
          f"{'run' if fsdp_ok else 'are left out: FSDP2 calls these'}",
          flush=True)
    return launches, lambda: rank_legs(spec, fsdp_ok)


def rank_legs(spec, fsdp_ok: bool) -> dict:
    """[mesh]'s legs of ranks that share the card, each with its flash
    checkpoint (module docstring).  Returns the flash launches of the
    steps after their restores."""
    import shutil
    import tempfile

    import torch

    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.parallel import (
        dp_workers,
        mesh_workers,
        process_group,
    )

    # fsdp2_tp2 saves the checkpoint that fsdp2 restores across meshes
    legs = [("tp2", dict(dp=1, tp=2), 2)]
    if fsdp_ok:
        legs += [("fsdp2_tp2", dict(dp=1, fsdp=2, tp=2), 4),
                 ("fsdp2", dict(dp=1, fsdp=2), 2)]
    small = dict(spec, model=dict(num_layers=DP_LAYERS, attention_impl="flash",
                                  max_seq_len=TRAIN_S))
    ref = mesh_workers.reference_losses(small, MESH_RANK_STEPS, "cuda")
    print(f"  {DP_LAYERS} layers on one rank, no mesh: losses "
          f"{[round(v, 6) for v in ref['loss']]}; step s "
          f"{[round(v, 4) for v in ref['step_s']]}")
    torch.cuda.empty_cache()
    per_step = {"flash_fwd": 2 * DP_LAYERS, "flash_bwd_dq": DP_LAYERS,
                "flash_bwd_dkv": DP_LAYERS}
    need = MESH_CKPT_BYTES_PER_PARAM * llama_param_count(
        LlamaConfig.llama2_1b(num_layers=DP_LAYERS)) + CKPT_META_MARGIN
    check_shm(2 * need, "two rank legs' checkpoints at once")
    root = tempfile.mkdtemp(prefix="mesh_ckpt_")
    ckpt_launches = dict.fromkeys(per_step, 0)
    want = {}  # fsdp2_tp2's records, which fsdp2 restores across meshes

    def spawn_leg(name, axes, world):
        runs = [dict(name=name, axes=axes, steps=MESH_RANK_STEPS,
                     save=dict(dir=os.path.join(root, name),
                               scope=f"mesh{os.getpid()}{name}"))]
        if name == "fsdp2_tp2":
            # and again under the distributed persist
            runs[0]["dist_save"] = dict(
                dir=os.path.join(root, "fsdp2_tp2_dist"),
                scope=f"mesh{os.getpid()}dist")
        if name == "fsdp2":
            runs.append(dict(
                name="fsdp2_tp2_to_fsdp2", axes=axes, steps=1,
                resume=dict(dir=os.path.join(root, "fsdp2_tp2"),
                            scope=f"mesh{os.getpid()}cross")))
            runs.append(dict(
                name="fsdp2_tp2_dist_to_fsdp2", axes=axes, steps=1,
                resume=dict(dir=os.path.join(root, "fsdp2_tp2_dist"),
                            scope=f"mesh{os.getpid()}crossd")))
        t0 = time.perf_counter()
        ranks = process_group.spawn(
            dp_workers.train_worker, world, (dict(small, runs=runs),),
            backend="gloo", device="cuda", timeout_s=MESH_TIMEOUT_S)
        return runs, ranks, time.perf_counter() - t0

    def check_leg(name, world, runs, ranks, seconds):
        print(f"  {name}, {world} ranks: {seconds:.1f} s with spawn, the "
              "checkpoint and its restores", flush=True)
        recs = [r["runs"][name] for r in ranks]
        check_rank_leg(name, recs, ref, per_step)
        saved = [r["ckpt"] for r in recs]
        check_ckpt_leg(name, saved, per_step, ckpt_launches)
        if name == "fsdp2_tp2":
            want["cross"] = saved[0]
            dist_saved = [r["dist_ckpt"] for r in recs]
            check_ckpt_leg(f"{name} (dist persist)", dist_saved,
                           per_step, ckpt_launches)
            check_dist_writes(name, dist_saved)
            want["dist"] = dist_saved[0]
        if len(runs) > 1:
            check_cross_restore(
                [r["runs"][runs[1]["name"]] for r in ranks], want["cross"],
                per_step, ckpt_launches)
            check_cross_restore(
                [r["runs"][runs[2]["name"]] for r in ranks], want["dist"],
                per_step, ckpt_launches, "a sealed distributed commit")

    try:
        # tp2 depends on no other leg: its ranks share the card with
        # fsdp2_tp2's and fsdp2's (its step seconds with theirs)
        with ThreadPoolExecutor(1) as pool:
            name, axes, world = legs[0]
            tp2 = pool.submit(spawn_leg, name, axes, world)
            for name, axes, world in legs[1:]:
                check_leg(name, world, *spawn_leg(name, axes, world))
            check_leg(legs[0][0], legs[0][2], *tp2.result())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not fsdp_ok:
        print("  the cross-mesh restore is left out with the fsdp legs")
    print(f"  flash launches over the steps after the restores, every "
          f"rank: {ckpt_launches}", flush=True)
    if not all(ckpt_launches.values()):
        raise AssertionError(f"the steps after the restores launched "
                             f"{ckpt_launches}")
    return ckpt_launches


def llama_param_count(cfg) -> int:
    """The parameters of a port Llama of ``cfg``: the embedding, each
    layer's attention, SwiGLU and two norms, the final norm and the
    head."""
    E, D = cfg.hidden_size, cfg.head_dim
    attn = E * D * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    layer = attn + 3 * E * cfg.intermediate_size + 2 * E
    return 2 * cfg.vocab_size * E + cfg.num_layers * layer + E


def check_shm(need: int, what: str) -> None:
    """Print /dev/shm's free bytes beside what a checkpoint needs; fail
    when they do not fit."""
    free = shm_free_bytes()
    print(f"  /dev/shm free {free / 1e9:.1f} GB; {what} needs "
          f"{need / 1e9:.1f} GB", flush=True)
    if free < need:
        raise AssertionError(f"/dev/shm has {free / 1e9:.2f} GB free, "
                             f"{what} needs {need / 1e9:.2f} GB")


def check_ckpt_leg(name, saved, per_step, launches) -> None:
    """Print and check the flash checkpoint of one leg of ranks
    (``dp_workers.save_and_restore``'s records, by rank): each rank's
    restores from shm and from storage ``torch.equal`` to the state
    saved, the step saved, the step after each restore with the loss of
    the uninterrupted run's next step (1e-6 relative) and the flash
    launches of a step; each rank's save and restore seconds.  Adds the
    flash launches of the steps after the restores to ``launches``."""
    for rank, c in enumerate(saved):
        want = c["next"]["loss"][0]
        print(f"  {name} rank {rank}: step {c['step']} blocking_save_s "
              f"{c['blocking_save_s']:.4f} (memory save "
              f"{c['memory_save_s']:.4f}) restore_shm_s "
              f"{c['restore_shm_s']:.3f} restore_storage_s "
              f"{c['restore_storage_s']:.3f}; next loss {want:.6f}, after "
              f"the restores {c['shm']['loss'][0]:.6f} (shm) "
              f"{c['storage']['loss'][0]:.6f} (storage)", flush=True)
        if not c["persisted"]:
            raise AssertionError(f"{name} rank {rank}: the storage save "
                                 "was not persisted")
        for source in ("shm", "storage"):
            if c[f"{source}_step"] != c["step"] or not c[f"{source}_equal"]:
                raise AssertionError(
                    f"{name} rank {rank}: the {source} restore gave step "
                    f"{c[f'{source}_step']} (saved {c['step']}), "
                    f"torch.equal {c[f'{source}_equal']}")
            loss = c[source]["loss"][0]
            if not math.isfinite(loss) or \
                    abs(loss - want) > RESTORED_LOSS_RTOL * abs(want):
                raise AssertionError(
                    f"{name} rank {rank}: the step after the {source} "
                    f"restore lost {loss}, the uninterrupted run {want} "
                    f"(tol {RESTORED_LOSS_RTOL})")
            counts = c[source]["flash_launches"][0]
            if counts != per_step:
                raise AssertionError(f"{name} rank {rank}: the step after "
                                     f"the {source} restore launched "
                                     f"{counts}, expected {per_step}")
            for k in launches:
                launches[k] += counts[k]


def check_dist_writes(name, saved) -> None:
    """Print and check a leg's save under the distributed persist
    (``dp_workers.save_and_restore(dist=True)``'s records, by rank): each
    rank's bytes_written and the sum, which must be one copy of the
    state's distinct boxes over the ranks' layouts (every box written by
    one rank), beside what the legacy persist writes (every rank its whole
    local state)."""
    c = saved[0]
    written = [c["hosts"][str(r)]["bytes_written"] for r in range(len(saved))]
    legacy = sum(r["local_bytes"] for r in saved)
    print(f"  {name} under the distributed persist: sealed step "
          f"{c['sealed_step']}; bytes_written per rank {written}, sum "
          f"{sum(written)} = one copy of the distinct boxes "
          f"{c['unique_bytes']} (the legacy persist writes {legacy}); "
          f"bytes_read/bytes_total of each rank's restore "
          f"{[(r['read_stats']['bytes_read'], r['read_stats']['bytes_total']) for r in saved]}",
          flush=True)
    if sum(written) != c["unique_bytes"] or not all(written) or \
            any(r["hosts"] != c["hosts"] for r in saved):
        raise AssertionError(f"{name}: the ranks wrote {written}, one copy "
                             f"of the state is {c['unique_bytes']}")


def check_cross_restore(recs, want, per_step, launches,
                        source: str = "storage") -> None:
    """The fsdp=2 ranks' restore of fsdp=2 x tp=2's stored step: the step
    saved, and the next step's loss and grad norm within the rank legs'
    limits of the uninterrupted fsdp=2 x tp=2 run's."""
    for rank, r in enumerate(recs):
        loss, norm = r["loss"][0], r["grad_norm"][0]
        next_loss = want["next"]["loss"][0]
        next_norm = want["next"]["grad_norm"][0]
        rel = abs(loss - next_loss) / abs(next_loss)
        rel_norm = abs(norm - next_norm) / abs(next_norm)
        read = r.get("read_stats") or {}
        print(f"  fsdp2_tp2 -> fsdp2 rank {rank}: restored step "
              f"{r['resumed_step']} from {source} in {r['restore_s']:.3f} s"
              + (f" reading {read['bytes_read']}/{read['bytes_total']} "
                 f"bytes ({read['bytes_read'] / read['bytes_total']:.3f})"
                 if read else "")
              + f"; next loss {loss:.6f} (fsdp2_tp2 uninterrupted "
              f"{next_loss:.6f}, rel {rel:.2e}, tol "
              f"{MESH_RANK_RTOL:.0e}); grad norm rel {rel_norm:.2e} (tol "
              f"{MESH_RANK_NORM_RTOL:.0e})", flush=True)
        if r["resumed_step"] != want["step"] or rel > MESH_RANK_RTOL or \
                rel_norm > MESH_RANK_NORM_RTOL or not math.isfinite(loss):
            raise AssertionError(f"fsdp2_tp2 -> fsdp2 rank {rank}: step "
                                 f"{r['resumed_step']}, loss {loss}, grad "
                                 f"norm {norm} against {next_loss}, "
                                 f"{next_norm}")
        if read and not 0 < read["bytes_read"] < read["bytes_total"]:
            raise AssertionError(f"fsdp2_tp2 -> fsdp2 rank {rank} read "
                                 f"{read} from {source}: not a part")
        if r["flash_launches"][0] != per_step:
            raise AssertionError(f"the cross-mesh step launched "
                                 f"{r['flash_launches'][0]}")
        for k in launches:
            launches[k] += r["flash_launches"][0][k]


def moe_phase(fa) -> dict:
    """The [moe] phase (module docstring); returns the flash launches of
    its steps."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.moe import (
        MoELlamaConfig,
        MoELlamaForCausalLM,
        expert_capacity,
        moe_loss_fn,
    )
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    cfg = MoELlamaConfig.llama2_1b(attention_impl="flash",
                                   num_layers=MOE_LAYERS,
                                   max_seq_len=TRAIN_S)
    model = MoELlamaForCausalLM(cfg, device="cuda", seed=0)
    n_params = model.num_params()
    trainer = Trainer(
        model,
        create_optimizer(peak_lr=3e-4, warmup_steps=10, total_steps=10_000,
                         moment_dtype=torch.bfloat16),
        loss_fn=moe_loss_fn(model), grads_dtype=torch.bfloat16,
        device="cuda")
    state = trainer.create_state()
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(TRAIN_B, TRAIN_S + 1))
    batch = {"input_ids": ids[:, :-1].astype(np.int32),
             "labels": ids[:, 1:].astype(np.int32)}
    C = expert_capacity(TRAIN_S, cfg.num_experts, cfg.top_k,
                        cfg.capacity_factor)
    L = cfg.num_layers
    per_step = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             L)
    print(f"  MoE llama2_1b width: {n_params / 1e9:.3f}B params, {L} "
          f"layers, hidden {cfg.hidden_size}, heads {cfg.num_heads}x"
          f"{cfg.head_dim}, FFN {cfg.intermediate_size}, vocab "
          f"{cfg.vocab_size}, E={cfg.num_experts} top-{cfg.top_k} "
          f"capacity_factor {cfg.capacity_factor} (C={C}); B={TRAIN_B} "
          f"S={TRAIN_S}; no remat", flush=True)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.reset_launches()
    step_s = []
    for step in range(1 + MOE_TIMED_STEPS):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        grown = {k: fa.launches[k] - before[k] for k in per_step}
        print(f"  step {step}{' (warm-up)' if step == 0 else ''}: "
              f"loss={loss:.4f} grad_norm={grad_norm:.4f} "
              f"{dt * 1e3:.1f} ms launches={grown}", flush=True)
        if not math.isfinite(loss) or not math.isfinite(grad_norm):
            raise AssertionError(f"[moe] non-finite loss/grad_norm at step "
                                 f"{step}")
        if grown != per_step:
            raise AssertionError(f"[moe] step {step} launched {grown}, "
                                 f"expected {per_step}")
        if step == 0 and abs(loss - math.log(cfg.vocab_size)) > 2.0:
            raise AssertionError(f"[moe] first loss {loss} is far from "
                                 f"ln({cfg.vocab_size})")
        if step:
            step_s.append(dt)
    mean_s, median_s = sum(step_s) / len(step_s), statistics.median(step_s)
    state = moe_profile(trainer, state, batch, fa, per_step, median_s)
    launches = dict(fa.launches)
    tokens = TRAIN_B * TRAIN_S
    print(f"  step_ms={mean_s * 1e3:.2f} (mean of {len(step_s)}; median "
          f"{median_s * 1e3:.2f}; min {min(step_s) * 1e3:.2f}) "
          f"tokens_per_s={tokens / mean_s:.0f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}; launches over "
          f"the phase's {2 + MOE_TIMED_STEPS} steps {launches}", flush=True)
    del trainer, state, model
    gc.collect()
    torch.cuda.empty_cache()
    moe_dispatch_check(cfg)
    return launches


MOE_PARTS = ("moe.routing", "moe.dispatch", "moe.experts", "moe.combine")
# how far a profiled step's split may stray from its kernel time (a
# kernel counted twice or lost would show)
SPLIT_RTOL = 1e-3


def kernel_owner(event, parts, part_of):
    """(phase, part) of the kernels CPU op ``event`` launched: the
    nearest enclosing span of ``parts`` (its forward), autograd node (the
    backward; of a part when its forward op was recorded under one, by
    sequence number), ``trainer.update`` or ``trainer.forward_backward``;
    ("other", None) under none of them (the batch's copy to the card).
    The backward (remat's recompute with it) runs on autograd's own
    thread, under no trainer span."""
    node = event
    while node is not None:
        if node.name in parts:
            return "forward", node.name
        if node.name.startswith("autograd::engine::evaluate_function"):
            return "backward", part_of.get(node.sequence_nr)
        if node.name == "trainer.update":
            return "update", None
        if node.name == "trainer.forward_backward":
            return "forward", None
        node = node.cpu_parent
    return "other", None


def is_span(name: str) -> bool:
    """A span's image on the device timeline, not a kernel."""
    return name.startswith(("trainer.", "moe.", "attention."))


def phase_split(prof, busy_ms: float, parts=()) -> dict:
    """{(phase, part, is a flash kernel): device ms} of a profiled step:
    each device activity of the trace counted once, under the CPU op of
    its correlation id (``kernel_owner``; the innermost op where two share
    an id), the spans' own device images left out.  (A CPU op's
    ``kernels`` list is no count: the [moe] step's lists summed 0.6% over
    its kernel time.)  ("unattributed", name) holds what was launched by
    an op the trace names but does not nest under a parent (on the card,
    some sums, products and quotients: ~2% of a MoE step's kernel time);
    the rows must add up to ``busy_ms``, the step's kernel time, within
    SPLIT_RTOL."""
    import collections

    from torch.autograd import DeviceType

    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    part_of = {}
    launcher = {}
    for e in cpu:
        span = e.cpu_parent
        while span is not None and span.name not in parts:
            span = span.cpu_parent
        if span is not None and e.sequence_nr >= 0:
            part_of[e.sequence_nr] = span.name
        if (e.id not in launcher
                or e.time_range.start >= launcher[e.id].time_range.start):
            launcher[e.id] = e
    trace = prof.profiler.kineto_results.events()
    op_name = {k.correlation_id(): k.name() for k in trace
               if k.device_type() == DeviceType.CPU}
    split = collections.Counter()
    for k in trace:
        if k.device_type() != DeviceType.CUDA or is_span(k.name()):
            continue
        op = launcher.get(k.linked_correlation_id())
        phase, part = (kernel_owner(op, parts, part_of) if op is not None
                       else ("unattributed",
                             op_name.get(k.linked_correlation_id())))
        flash = "fa_" in k.name() and "_kernel" in k.name()
        split[(phase, part, flash)] += k.duration_ns() / 1e6
    total = sum(split.values())
    if abs(total - busy_ms) > SPLIT_RTOL * busy_ms:
        raise AssertionError(f"the split counts {total:.3f} ms of kernels "
                             f"in a step that ran {busy_ms:.3f} ms of them")
    return split


def moe_profile(trainer, state, batch, fa, per_step, step_s):
    """One more [moe] step under torch.profiler: the device's busy share
    and its kernel time split by what launched each kernel
    (``phase_split``): the flash kernels, each MoE span's forward and the
    backward of the ops it recorded, the rest of the forward and the
    backward, the optimizer update, and the kernels outside the step's
    spans."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = dict(fa.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = trainer.train_step(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
    grown = {k: fa.launches[k] - before[k] for k in per_step}
    if grown != per_step:
        raise AssertionError(f"[moe] profiled step launched {grown}")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not is_span(e.name)]
    if not kernels:
        raise AssertionError("the profiler saw no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    rows, loose = collections.Counter(), collections.Counter()
    for (phase, part, flash), ms in phase_split(prof, busy,
                                                MOE_PARTS).items():
        if phase == "unattributed":
            loose[part] += ms
        if flash:
            rows["flash kernels (fwd, dQ, dK/dV)"] += ms
        elif phase == "update":
            rows["optimizer update"] += ms
        elif phase in ("forward", "backward"):
            rows[f"{part or 'other'} {phase}"] += ms
        else:
            rows[f"{phase} (outside the step's spans)"
                 if phase == "other" else phase] += ms
    print(f"  profiled step: device busy {busy:.1f} ms = "
          f"{busy / (step_s * 1e3):.3f} of the {step_s * 1e3:.1f} ms median "
          f"step (idle share {1 - busy / (step_s * 1e3):.3f})")
    labels = (["flash kernels (fwd, dQ, dK/dV)"]
              + [f"{p} {d}" for p in MOE_PARTS + ("other",)
                 for d in ("forward", "backward")]
              + ["optimizer update", "other (outside the step's spans)",
                 "unattributed"])
    for label in labels:
        print(f"    {label}: {rows[label]:.1f} ms "
              f"({rows[label] / busy:.3f} of busy)")
    print(f"    (unattributed: launched by ops the trace does not nest, "
          f"{[(n, round(ms, 2)) for n, ms in loose.most_common(3)]})")
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    for name, ms in by_name.most_common(5):
        print(f"    top kernel {ms:8.2f} ms  {name[:100]}")
    return state


def moe_dispatch_check(cfg) -> None:
    """The capacity dispatch against the dense oracle at full width in
    fp32 with capacity_factor = E / top_k: nothing drops, so the two
    agree (tests/test_moe.py:53's criterion, atol 2e-5)."""
    import torch

    from dlrover_tpu_torch.models.moe import MoEMLP

    fields = dict(dtype=torch.float32,
                  capacity_factor=cfg.num_experts / cfg.top_k)
    disp = MoEMLP(dataclasses.replace(cfg, router_impl="dispatch",
                                      **fields), device="cuda")
    dense = MoEMLP(dataclasses.replace(cfg, router_impl="dense", **fields),
                   device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.no_grad():
        for p in disp.parameters():  # unit-scale activations
            fan_in = p.shape[-1] if p.dim() == 2 else p.shape[-2]
            p.normal_(0.0, fan_in ** -0.5, generator=gen)
        dense.load_state_dict(disp.state_dict())
        x = torch.randn(2, TRAIN_S, cfg.hidden_size, device="cuda",
                        generator=gen)
        got, want = disp(x), dense(x)
    e = (got - want).abs().max().item()
    print(f"  dispatch vs dense oracle, fp32, capacity_factor "
          f"{fields['capacity_factor']} (no drops), x {tuple(x.shape)}: "
          f"max_abs_err={e:.3e} tol={MOE_ORACLE_ATOL:.0e} (max |dense| "
          f"{want.abs().max().item():.3e})", flush=True)
    if not (torch.isfinite(got).all() and e <= MOE_ORACLE_ATOL):
        raise AssertionError("the dispatch disagrees with the dense oracle")


def check_rank_leg(name, recs, ref, flash_per_step,
                   batch_rows: int = TRAIN_B) -> None:
    """Print and check one run of ranks sharing the card: its losses and
    grad norms equal on every rank and within ``MESH_RANK_RTOL`` and
    ``MESH_RANK_NORM_RTOL`` relative of ``ref``'s (one rank at the same
    depth), its flash launches per step per rank (``flash_per_step``: the
    counts, or a function of a rank's mesh coordinate giving them)."""
    def rel(key):
        return max(abs(a - b) / abs(b)
                   for a, b in zip(recs[0][key], ref[key]))

    loss, norm = recs[0]["loss"], recs[0]["grad_norm"]
    peaks = [round(r["peak_mem_bytes"] / 2**30, 2) for r in recs]
    print(f"  {name}: {len(recs)} gloo ranks on the card, mesh "
          f"{ {k: v for k, v in recs[0]['shape'].items() if v > 1} }, "
          f"global B={batch_rows}; losses {[round(v, 6) for v in loss]} (max "
          f"rel {rel('loss'):.2e} vs one rank, tol {MESH_RANK_RTOL:.0e}); "
          f"grad norms {[round(v, 6) for v in norm]} (max rel "
          f"{rel('grad_norm'):.2e}, tol {MESH_RANK_NORM_RTOL:.0e}); step s "
          f"{[round(v, 3) for v in recs[0]['step_s']]}; flash launches "
          f"per step, by rank {[r['flash_launches'][-1] for r in recs]}; "
          f"per-rank peak GiB {peaks}", flush=True)
    for r in recs:
        if r["loss"] != loss or r["grad_norm"] != norm:
            raise AssertionError(f"{name}: ranks report different losses "
                                 "or grad norms")
        want = (flash_per_step(r["coord"]) if callable(flash_per_step)
                else flash_per_step)
        for counts in r["flash_launches"]:
            if counts != want:
                raise AssertionError(f"{name} launched {counts} per step "
                                     f"at {r['coord']}, expected {want}")
    if (not all(math.isfinite(v) for v in loss + norm)
            or rel("loss") > MESH_RANK_RTOL
            or rel("grad_norm") > MESH_RANK_NORM_RTOL):
        raise AssertionError(
            f"{name}: losses {loss} and grad norms {norm} against one "
            f"rank's {ref['loss']} and {ref['grad_norm']} (tol "
            f"{MESH_RANK_RTOL}, {MESH_RANK_NORM_RTOL})")


def ring_flash_op() -> None:
    """[cp flash] op: ``ring_flash_attention`` alone on 2 gloo ranks
    sharing the card, held against one-rank flash on the whole sequence
    (module docstring)."""
    from dlrover_tpu_torch.parallel import mesh_workers, process_group

    t0 = time.perf_counter()
    ranks = process_group.spawn(
        mesh_workers.ring_flash_check_worker, 2, (dict(
            shape=(TRAIN_B, TRAIN_S, 16, 128), seed=6, dtype="bfloat16",
            tile=REL_TILE, iters=RING_FLASH_ITERS),), backend="gloo",
        device="cuda", timeout_s=180.0)
    for rank, rec in enumerate(ranks):
        for name, e in rec["errors"].items():
            tol = (FWD_ATOL if name == "out"
                   else GRAD_REL * max(1.0, e["max_abs"]))
            print(f"  [cp flash] op, cp=2 rank {rank}, B={TRAIN_B} "
                  f"S={TRAIN_S} H=16 D=128 causal bf16, {name} vs one-rank "
                  f"flash: max_abs_err={e['max_abs_err']:.3e} tol={tol:.3e}"
                  f" rel_err={e['rel_err']:.3e} rel_tol={REL_TOL:.0e}")
            if not (e["finite"] and e["max_abs_err"] <= tol
                    and e["rel_err"] <= REL_TOL):
                raise AssertionError(f"ring_flash_attention's {name} on "
                                     f"rank {rank} disagrees with one-rank "
                                     "flash")
        # rank r holds r + 1 chunks at or before its own
        want = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                             rank + 1)
        print(f"  [cp flash] op, rank {rank}: flash launches of one forward "
              f"and backward {rec['launches']}", flush=True)
        if rec["launches"] != want:
            raise AssertionError(f"rank {rank} launched {rec['launches']}, "
                                 f"expected {want}")
    print(f"  [cp flash] op: forward+backward median of {RING_FLASH_ITERS}"
          f", 2 ranks sharing the card, host-staged shifts: rank 0 "
          f"{ranks[0]['ring_s'] * 1e3:.2f} ms, rank 1 "
          f"{ranks[1]['ring_s'] * 1e3:.2f} ms; one-rank flash on the whole "
          f"sequence {ranks[0]['one_rank_s'] * 1e3:.2f} ms (rank 0 alone); "
          f"{time.perf_counter() - t0:.1f} s with spawn", flush=True)


def cp_flash_launches(layers: int, remat: bool):
    """The flash launches per step of a rank at a cp coordinate: the ring
    of flash blocks runs cp rank c's c + 1 blocks per layer, the forward
    twice under remat."""
    def per_step(coord):
        blocks = (coord["cp"] + 1) * layers
        return {"flash_fwd": blocks * (2 if remat else 1),
                "flash_bwd_dq": blocks, "flash_bwd_dkv": blocks}
    return per_step


def ep_cp_phase() -> dict:
    """The [ep] and [cp] phases: ranks sharing the card over gloo at full
    width (module docstring).  Returns, per flash kernel, its launches a
    step on each rank of each [cp] leg that runs the flash kernels."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.parallel import (
        dp_workers,
        mesh_workers,
        process_group,
    )

    t0 = time.perf_counter()
    checks = process_group.spawn(
        mesh_workers.ring_check_worker, 2, (dict(
            shape=(TRAIN_B, TRAIN_S, 16, 128), seed=5,
            dtypes=tuple(RING_ATOL)),), backend="gloo", device="cuda",
        timeout_s=120.0)
    for rank, rec in enumerate(checks):
        for dtype, r in rec.items():
            print(f"  [cp] ring attention, cp=2 rank {rank}, B={TRAIN_B} "
                  f"S={TRAIN_S} H=16 D=128 causal, {dtype}: max_abs_err vs "
                  f"reference_attention {r['max_abs_err']:.3e} (tol "
                  f"{RING_ATOL[dtype]:.0e}); ring forward {r['ring_s']:.3f} "
                  "s", flush=True)
            if not (r["finite"] and r["max_abs_err"] <= RING_ATOL[dtype]):
                raise AssertionError(f"ring attention in {dtype} disagrees "
                                     "with the reference core")
    print(f"  the op check took {time.perf_counter() - t0:.1f} s with "
          "spawn", flush=True)
    ring_flash_op()

    ids = np.random.default_rng(0).integers(0, 32000,
                                            size=(TRAIN_B, TRAIN_S + 1))
    base = dict(
        preset="llama2_1b", state_dict=None, seed=0,
        batch={"input_ids": ids[:, :-1].astype(np.int32),
               "labels": ids[:, 1:].astype(np.int32)},
        optimizer=dict(peak_lr=3e-4, warmup_steps=10, total_steps=10_000,
                       moment_dtype=torch.bfloat16),
        grads_dtype=torch.bfloat16)

    def model(impl, layers, moe=False):
        fields = dict(model=dict(num_layers=layers, attention_impl=impl,
                                 max_seq_len=TRAIN_S))
        return dict(fields, family="moe") if moe else fields

    # one rank at the legs' depth, by model: the specs the legs are held
    # against
    refs = {"moe": model("flash", DP_LAYERS, moe=True),
            "reference": model("reference", DP_LAYERS),
            "flash": model("flash", DP_LAYERS)}
    ring = model("ring", DP_LAYERS)
    flash = {layers: dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv"), layers)
             for layers in (0, DP_LAYERS)}
    # (name, ranks, axes, spec, reference, flash per step): one spawn per
    # world size runs its legs in turn
    legs = [("[ep] ep2", 2, dict(dp=1, ep=2), refs["moe"], "moe",
             flash[DP_LAYERS]),
            ("[cp] cp2", 2, dict(dp=1, cp=2), ring, "reference", flash[0]),
            ("[ep] dp2_ep2", 4, dict(dp=2, ep=2), refs["moe"], "moe",
             flash[DP_LAYERS]),
            ("[cp] tp2_cp2", 4, dict(dp=1, tp=2, cp=2), ring, "reference",
             flash[0]),
            ("[cp] cp2_flash", 2, dict(dp=1, cp=2), refs["flash"], "flash",
             cp_flash_launches(DP_LAYERS, remat=True)),
            ("[cp] cp2_moe", 2, dict(dp=1, cp=2), refs["moe"], "moe",
             cp_flash_launches(DP_LAYERS, remat=False)),
            ("[cp] tp2_cp2_flash", 4, dict(dp=1, tp=2, cp=2), refs["flash"],
             "flash", cp_flash_launches(DP_LAYERS, remat=True))]
    cp_launches = {k: {} for k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv")}
    ref_losses = {}
    for key, spec in refs.items():
        t0 = time.perf_counter()
        ref_losses[key] = mesh_workers.reference_losses(
            dict(base, **spec), MESH_RANK_STEPS, "cuda")
        print(f"  {spec['model']['num_layers']} layers on one rank, no mesh "
              f"({key}): losses "
              f"{[round(v, 6) for v in ref_losses[key]['loss']]}; step s "
              f"{[round(v, 3) for v in ref_losses[key]['step_s']]}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)
    for world in sorted({leg[1] for leg in legs}):
        mine = [leg for leg in legs if leg[1] == world]
        t0 = time.perf_counter()
        ranks = process_group.spawn(
            dp_workers.train_worker, world, (dict(base, runs=[
                dict(name=name, axes=axes, steps=MESH_RANK_STEPS, spec=spec)
                for name, _, axes, spec, *_ in mine]),),
            backend="gloo", device="cuda", timeout_s=MESH_TIMEOUT_S)
        print(f"  {world} ranks: {time.perf_counter() - t0:.1f} s with "
              "spawn", flush=True)
        for name, _, _, _, ref, flash_per_step in mine:
            recs = [r["runs"][name] for r in ranks]
            check_rank_leg(name, recs, ref_losses[ref], flash_per_step)
            if callable(flash_per_step):  # a [cp] leg through the kernels
                for kernel, per_leg in cp_launches.items():
                    per_leg[name[5:]] = [r["flash_launches"][-1][kernel]
                                         for r in recs]
    return cp_launches


def card_vs_cpu(make, inputs, label: str) -> None:
    """``make(device)`` builds a tiny fp32 model; the same weights on the
    card and on the CPU give the same logits for ``inputs`` within
    CARD_CPU_ATOL."""
    import torch

    cpu = make("cpu")
    card = make("cuda")
    card.load_state_dict(cpu.state_dict())
    with torch.no_grad():
        want = cpu(inputs)
        got = card(inputs.cuda()).cpu()
    e = (got - want).abs().max().item()
    print(f"  tiny {label} fp32 logits on the card vs the CPU, same "
          f"weights: max_abs_err={e:.3e} tol={CARD_CPU_ATOL:.0e} (max "
          f"|logit| {want.abs().max().item():.3e}) shape "
          f"{tuple(got.shape)}", flush=True)
    if not (torch.isfinite(got).all() and e <= CARD_CPU_ATOL):
        raise AssertionError(f"tiny {label} logits differ on the card")


def family_train(name, trainer, batch, tokens: int, first_loss: float,
                 flops_per_step=None):
    """The [gpt] and [vit] steps: one warm-up and TIMED_STEPS timed steps
    (finite losses, the first near ``first_loss``), no flash launch, the
    mean, median and shortest step, the rate, MFU when ``flops_per_step``
    is given and the peak; then one step under torch.profiler, its device
    time split by ``phase_split``."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.models.gpt import ATTENTION_SPAN
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    state = trainer.create_state()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa.reset_launches()
    step_s = []
    for step in range(1 + TIMED_STEPS):
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"  step {step}{' (warm-up)' if step == 0 else ''}: "
              f"loss={loss:.4f} grad_norm={grad_norm:.4f} "
              f"{dt * 1e3:.1f} ms", flush=True)
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            raise AssertionError(f"[{name}] non-finite loss/grad_norm at "
                                 f"step {step}")
        if step == 0 and abs(loss - first_loss) > 2.0:
            raise AssertionError(f"[{name}] first loss {loss} is far from "
                                 f"{first_loss:.4f}")
        if step:
            step_s.append(dt)
    if any(fa.launches.values()):
        raise AssertionError(f"[{name}] launched flash kernels "
                             f"{dict(fa.launches)}: the reference attends "
                             "through the plain core")
    mean_s, median_s = sum(step_s) / len(step_s), statistics.median(step_s)
    mfu = ("" if flops_per_step is None else
           f" mfu={flops_per_step / mean_s / PEAK_BF16_FLOPS:.4f} "
           "[(6N + 6*L*h*S)*tokens / 989e12, remat not counted]")
    unit = "tokens" if name == "gpt" else "images"
    print(f"  step_ms={mean_s * 1e3:.2f} (mean of {len(step_s)}; median "
          f"{median_s * 1e3:.2f}; min {min(step_s) * 1e3:.2f}) "
          f"{unit}_per_s={tokens / mean_s:.0f}{mfu} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = trainer.train_step(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not is_span(e.name)]
    if not kernels:
        raise AssertionError("the profiler saw no device activity")
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    rows = collections.Counter()
    for (phase, part, _), ms in phase_split(prof, busy,
                                            (ATTENTION_SPAN,)).items():
        if phase == "update":
            rows["optimizer update"] += ms
        elif phase in ("forward", "backward"):
            what = "attention core" if part else "the rest of"
            rows[f"{what} {phase}"] += ms
        else:
            rows[phase] += ms
    print(f"  profiled step: device busy {busy:.1f} ms = "
          f"{busy / (median_s * 1e3):.3f} of the {median_s * 1e3:.1f} ms "
          f"median step (idle share {1 - busy / (median_s * 1e3):.3f})")
    for label in ("attention core forward", "attention core backward",
                  "the rest of forward", "the rest of backward",
                  "optimizer update", "other", "unattributed"):
        print(f"    {label}: {rows[label]:.1f} ms "
              f"({rows[label] / busy:.3f} of busy)")
    print("    (attention core: reference_attention under its span, the "
          "forward with remat's recompute; the rest of backward holds the "
          "other recompute)")
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    for kname, ms in by_name.most_common(5):
        print(f"    top kernel {ms:8.2f} ms  {kname[:100]}")
    return state


def gpt_phase() -> None:
    """The [gpt] phase (module docstring)."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    tiny = GPTConfig.tiny(dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, tiny.vocab_size, size=(2, tiny.block_size)))
    card_vs_cpu(lambda dev: GPT(tiny, device=dev, seed=1), ids, "GPT")

    cfg = GPTConfig.gpt2_xl()
    model = GPT(cfg, device="cuda", seed=0)
    n_params = model.num_params()
    trainer = Trainer(
        model,
        create_optimizer(peak_lr=3e-4, warmup_steps=10, total_steps=10_000,
                         moment_dtype=torch.bfloat16),
        grads_dtype=torch.bfloat16, device="cuda")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            size=(GPT_B, GPT_S + 1))
    batch = {"input_ids": ids[:, :-1].astype(np.int32),
             "labels": ids[:, 1:].astype(np.int32)}
    print(f"  gpt2_xl: {n_params / 1e9:.3f}B params, {cfg.n_layer} layers, "
          f"n_embd {cfg.n_embd}, heads {cfg.n_head}x"
          f"{cfg.n_embd // cfg.n_head}, vocab {cfg.vocab_size}, block "
          f"{cfg.block_size}; B={GPT_B} S={GPT_S}; remat, the plain "
          "attention core", flush=True)
    tokens = GPT_B * GPT_S
    flops = (6 * n_params + 6 * cfg.n_layer * cfg.n_embd * GPT_S) * tokens
    family_train("gpt", trainer, batch, tokens, math.log(cfg.vocab_size),
                 flops)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()


def vit_phase() -> None:
    """The [vit] phase (module docstring)."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.vit import (
        ViTConfig,
        ViTForImageClassification,
        vit_loss_fn,
    )
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    tiny = ViTConfig.tiny(dtype=torch.float32)

    def make(dev):
        model = ViTForImageClassification(tiny, device=dev, seed=1)
        with torch.no_grad():  # a nonzero head, so the logits say more
            model.head.weight.normal_(
                0.0, 0.1, generator=torch.Generator(dev).manual_seed(2))
        return model

    images = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, tiny.image_size, tiny.image_size, 3)).astype(np.float32))
    card_vs_cpu(make, images, "ViT")

    cfg = ViTConfig.large()
    model = ViTForImageClassification(cfg, device="cuda", seed=0)
    n_params = model.num_params()
    trainer = Trainer(
        model,
        create_optimizer(peak_lr=3e-4, warmup_steps=10, total_steps=10_000,
                         moment_dtype=torch.bfloat16),
        loss_fn=vit_loss_fn(model), grads_dtype=torch.bfloat16,
        device="cuda")
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal(
        (VIT_B, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
        "labels": rng.integers(0, cfg.num_classes, VIT_B).astype(np.int32)}
    print(f"  ViT-L/16: {n_params / 1e6:.1f}M params, {cfg.num_layers} "
          f"layers, hidden {cfg.hidden_size}, heads {cfg.num_heads}x"
          f"{cfg.hidden_size // cfg.num_heads}, {cfg.image_size}^2 images, "
          f"patch {cfg.patch_size}, {cfg.num_patches + 1} tokens, "
          f"{cfg.num_classes} classes; B={VIT_B}; remat", flush=True)
    # the zero-initialised head gives zero logits: the first loss is
    # ln(classes)
    family_train("vit", trainer, batch, VIT_B, math.log(cfg.num_classes))
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()


def pp_phase() -> dict:
    """The [pp] phase (module docstring); returns the flash launches over
    every rank's steps of its legs."""
    import numpy as np
    import torch

    from dlrover_tpu_torch.parallel import mesh_workers, process_group
    from dlrover_tpu_torch.parallel.pipeline import microbatch_efficiency

    spec = dict(preset="llama2_1b", state_dict=None, seed=0,
                model=dict(num_layers=PP_LAYERS, attention_impl="flash",
                           max_seq_len=TRAIN_S),
                optimizer=dict(peak_lr=3e-4, warmup_steps=10,
                               total_steps=10_000,
                               moment_dtype=torch.bfloat16))
    total = dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 0)
    legs = []
    for name, axes, world, batch_rows in PP_LEGS:
        ids = np.random.default_rng(0).integers(
            0, 32000, size=(batch_rows, TRAIN_S + 1))
        run = dict(name=name, axes=axes, num_microbatches=PP_MICROBATCHES,
                   steps=MESH_RANK_STEPS,
                   batch={"input_ids": ids[:, :-1].astype(np.int32),
                          "labels": ids[:, 1:].astype(np.int32)})
        t0 = time.perf_counter()
        ref = mesh_workers.reference_pipeline(spec, run, "cuda")
        print(f"  {PP_LAYERS} layers on one rank, no pipeline, B="
              f"{batch_rows}: losses {[round(v, 6) for v in ref['loss']]}; "
              f"step s {[round(v, 3) for v in ref['step_s']]}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        legs.append((name, axes, world, batch_rows, run, ref))
        gc.collect()
        torch.cuda.empty_cache()

    def spawn_leg(world, run):
        t0 = time.perf_counter()
        ranks = process_group.spawn(
            mesh_workers.pipeline_worker, world, (dict(spec, runs=[run]),),
            backend="gloo", device="cuda", timeout_s=MESH_TIMEOUT_S)
        return ranks, time.perf_counter() - t0

    # the legs share the card at once (their step seconds with each
    # other's)
    with ThreadPoolExecutor(len(legs)) as pool:
        spawned = [pool.submit(spawn_leg, leg[2], leg[4]) for leg in legs]
        spawned = [f.result() for f in spawned]
    for (name, axes, world, batch_rows, run, ref), (ranks, seconds) in zip(
            legs, spawned):
        print(f"  {name}, {world} ranks: {seconds:.1f} s with spawn",
              flush=True)
        recs = [r["runs"][name] for r in ranks]
        # per rank a step: each stage's layers once per microbatch, and
        # the forward again in remat's recompute; bubbles compute nothing
        per = PP_LAYERS // axes["pp"] * PP_MICROBATCHES
        want = {"flash_fwd": 2 * per, "flash_bwd_dq": per,
                "flash_bwd_dkv": per}
        check_rank_leg(f"[pp] {name}", recs, ref, want,
                       batch_rows=batch_rows)
        for r in recs:
            for counts in r["flash_launches"]:
                for k in total:
                    total[k] += counts[k]
        print(f"  microbatch_efficiency(M={PP_MICROBATCHES}, "
              f"P={axes['pp']}) = "
              f"{microbatch_efficiency(PP_MICROBATCHES, axes['pp']):.3f}; "
              f"step s per rank {[[round(v, 3) for v in r['step_s']] for r in recs]}",
              flush=True)
    return total


def shm_free_bytes() -> int:
    st = os.statvfs("/dev/shm")
    return st.f_bavail * st.f_frsize


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def ckpt_depth(state, num_layers: int, shm_free: int) -> int:
    """The largest depth at full width whose state fits in /dev/shm (the
    phase holds one snapshot segment at a time), from the bytes of layer
    0's leaves and of the rest."""
    from dlrover_tpu_torch.common.pytree import flatten_with_path
    from dlrover_tpu_torch.trainer.flash_checkpoint.bench import state_nbytes

    total = state_nbytes(state) + CKPT_META_MARGIN
    per_layer = sum(leaf.numel() * leaf.element_size()
                    for path, leaf in flatten_with_path(state)
                    if "layers.0." in path)
    if total <= shm_free:
        return num_layers
    depth = (shm_free - (total - num_layers * per_layer)) // per_layer
    if depth < 1:
        raise AssertionError(f"/dev/shm has {shm_free / 1e9:.2f} GB free: "
                             "not even one layer's state fits")
    return int(depth)


def ckpt_subject(trainer, state, batch, per_step, copies: int = 1,
                 max_layers: int = 0):
    """What a checkpoint phase saves: the training phase's trainer and
    state, or, when ``copies`` segments of its state do not fit in
    /dev/shm at once or its depth is above ``max_layers`` (0: no bound), a
    trainer of the largest depth at full width whose state does and that
    is within the bound, one step trained, printed as "reduced: depth N of
    22".  Returns ``(trainer, state, depth, flash launches per step)``."""
    import torch

    from dlrover_tpu_torch.common.pytree import flatten_with_path
    from dlrover_tpu_torch.models.llama import LlamaForCausalLM
    from dlrover_tpu_torch.trainer.flash_checkpoint import bench
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    layers = trainer.model.config.num_layers
    shm_free, ram = shm_free_bytes(), host_available_bytes()
    print(f"  state {bench.state_nbytes(state) / 1e9:.3f} GB in "
          f"{len(flatten_with_path(state))} leaves ({layers} layers); /dev/shm "
          f"free {shm_free / 1e9:.1f} GB; host RAM available "
          f"{ram / 1e9:.1f} GB", flush=True)
    depth = ckpt_depth(state, layers, shm_free // copies)
    if max_layers:
        depth = min(depth, max_layers)
    if depth < layers:
        print(f"  reduced: depth {depth} of {layers} (shm "
              f"{shm_free / 1e9:.1f} GB free for {copies} "
              f"segment{'s' if copies > 1 else ''}; at most "
              f"{max_layers or layers} layers)", flush=True)
        cfg = dataclasses.replace(trainer.model.config, num_layers=depth)
        trainer = Trainer(
            LlamaForCausalLM(cfg, device=trainer.device, seed=0),
            create_optimizer(peak_lr=3e-4, warmup_steps=10,
                             total_steps=10_000, moment_dtype=torch.bfloat16),
            grads_dtype=torch.bfloat16, device=trainer.device)
        state = trainer.create_state()
        state, _ = trainer.train_step(state, batch)
        per_step = {k: v * depth // layers for k, v in per_step.items()}
    return trainer, state, depth, per_step


def flash_checkpoint(fa, trainer, state, batch, per_step):
    """The [flash checkpoint] phase on the training phase's trainer and
    state; returns its JSON record."""
    import shutil
    import struct
    import tempfile

    import torch

    from dlrover_tpu_torch.common.pytree import flatten_with_path
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        bench,
        snapshot,
    )

    layers = trainer.model.config.num_layers
    shm_free, ram = shm_free_bytes(), host_available_bytes()
    trainer, state, depth, per_step = ckpt_subject(trainer, state, batch,
                                                   per_step)
    state_bytes = bench.state_nbytes(state)
    phase_t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="dlrover_tpu_torch_ckpt_")
    scope = f"smoke{os.getpid()}"
    ref = {}
    record = dict(state_gb=state_bytes / 1e9, layers=depth,
                  reduced=depth < layers, shm_free_gb=shm_free / 1e9,
                  ram_available_gb=ram / 1e9)
    try:
        sync_s, phases, sync_paths = bench.sync_save_s(
            state, ckpt_dir, f"{scope}s", step=state.step,
            device=trainer.device)
        split = [(round(p["device_to_host_s"], 4), round(p["shm_write_s"], 4))
                 for p in phases]
        print(f"  sync memory save (async_snapshot=False): blocking_save_s "
              f"{sync_s[0]:.4f} (fresh segment and pinned memory), "
              f"{sync_s[1]:.4f} (again); device to pinned host / host to "
              f"shm {split} s; paths {sync_paths}", flush=True)
        record.update(sync_blocking_save_s=sync_s, sync_phases=phases,
                      sync_paths=sync_paths)

        # the state at the snapshot step, on the card; allocated before the
        # bench's first step, so that the copy takes no memory the steps
        # have cached
        ref.update({path: torch.empty_like(leaf) for path, leaf in
                    flatten_with_path(state) if isinstance(leaf, torch.Tensor)})

        def on_snapshot(st):
            for path, leaf in flatten_with_path(st):
                if isinstance(leaf, torch.Tensor):
                    ref[path].copy_(leaf)
                else:
                    ref[path] = leaf

        def check_equal(label, st):
            bad = [path for path, leaf in flatten_with_path(st)
                   if not (torch.equal(leaf, ref[path])
                           if isinstance(leaf, torch.Tensor)
                           else leaf == ref[path])]
            if bad or len(flatten_with_path(st)) != len(ref):
                raise AssertionError(f"{label} restore differs from the "
                                     f"state at the snapshot step: {bad[:5]}")

        def verify(source, st, first_loss):
            record["first_loss_from_snapshot"] = first_loss
            check_equal(source, st)
            print(f"  {source} restore: every one of {len(ref)} leaves "
                  f"torch.equal to the state at the snapshot step",
                  flush=True)
            if source != "storage":
                return
            bf16 = [n for n, p in trainer.model.named_parameters()
                    if not torch.equal(p, st.params[n].to(p.dtype))]
            if bf16:
                raise AssertionError(f"compute copy stale after the restore: "
                                     f"{bf16[:5]}")
            record["compute_copy_equal"] = True

        fa.reset_launches()
        state, detail = bench.run(trainer, state, batch, ckpt_dir, scope,
                                  steps=CKPT_STEPS, on_snapshot=on_snapshot,
                                  verify=verify)
        phase_steps = 2 * CKPT_STEPS + 1
        grown = dict(fa.launches)
        want = {k: v * phase_steps for k, v in per_step.items()}
        if grown != want:
            raise AssertionError(f"the phase's {phase_steps} steps launched "
                                 f"{grown}, expected {want}")
        record.update(detail)
        print(f"  async memory save (warm-up) and async storage save: paths "
              f"{detail['save_paths']}; blocking_save_s "
              f"{detail['blocking_save_s']:.5f}", flush=True)
        print(f"  steps without a save "
              f"{[round(x, 4) for x in detail['steps_no_save']]} s; during "
              f"staging {[round(x, 4) for x in detail['steps_during_staging']]}"
              f" s; median inflation {detail['staging_inflation_x']:.3f}x; "
              f"staging_s {detail['staging_s']:.2f}, persist_total_s "
              f"{detail['persist_total_s']:.2f}", flush=True)
        print(f"  restore_shm_s {detail['restore_shm_s']:.3f} "
              f"(restore_shm_host_s {detail['restore_shm_host_s']:.3f}); "
              f"restore_storage_s {detail['restore_storage_s']:.3f}; flash "
              f"launches over the phase's {phase_steps} steps {grown}",
              flush=True)
        # one step from the restored state: the forward runs on the
        # restored compute copy, so it must reproduce the loss of the
        # first step trained from the snapshot
        state, metrics = trainer.train_step(state, batch)
        loss, first = metrics["loss"].item(), record["first_loss_from_snapshot"]
        record["loss_after_restore"] = loss
        print(f"  one step from the storage restore: loss {loss!r} (the "
              f"first step from the snapshot: {first!r})", flush=True)
        if not (math.isfinite(loss)
                and abs(loss - first) <= RESTORED_LOSS_RTOL * abs(first)):
            raise AssertionError(f"loss {loss} after the restore; the first "
                                 f"step from the snapshot had {first}")

        # a torn shm reads as no snapshot: a newer memory snapshot (step
        # label 2) with its generation made odd restores the storage step
        torn = Checkpointer(ckpt_dir, scope=f"{scope}t", async_snapshot=False,
                            device=trainer.device)
        try:
            torn.save_checkpoint(bench.SAVE_STEP + 1, state)
            buf = torn.engine._shm.buf
            off = snapshot._GEN_OFF
            (gen,) = struct.unpack(">Q", bytes(buf[off:off + 8]))
            buf[off:off + 8] = struct.pack(">Q", gen + 1)
            t0 = time.perf_counter()
            restored, step = torn.load_checkpoint(state, trainer=trainer)
            torn_s = time.perf_counter() - t0
        finally:
            torn.engine.unlink_memory()
            torn.close()
        if step != bench.SAVE_STEP:
            raise AssertionError(f"a torn shm restored step {step}, not the "
                                 f"storage step {bench.SAVE_STEP}")
        check_equal("torn-shm", restored)
        print(f"  torn shm (odd generation over step {bench.SAVE_STEP + 1}): "
              f"load returned the storage step {step} in {torn_s:.3f} s, "
              f"torch.equal to the snapshot", flush=True)
        record.update(torn_restore_step=step, torn_restore_s=torn_s)
    finally:
        ref.clear()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"  the phase took {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return record


def dist_persist_phase(fa, trainer, state, batch, per_step, then=None):
    """The [dist persist] phase on the training phase's trainer and state
    (module docstring); returns its JSON record.  ``then(trainer,
    ckpt_dir, step, want, uninterrupted, per_step, donor)`` runs after the
    phase's checks and before its sealed commit (``step``, in
    ``ckpt_dir``), ``want`` (the saved state's leaves, on the card) and
    ``donor`` (the saving Checkpointer, whose segment holds ``step``) are
    released: the [peer restore] phase.  With ``then`` the state is cut to
    depth where /dev/shm cannot hold two segments of it."""
    import shutil
    import tempfile

    import torch

    from dlrover_tpu_torch.common.pytree import flatten_with_path
    from dlrover_tpu_torch.parallel.dp_workers import dist_persist
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        StorageType,
        bench,
    )
    from dlrover_tpu_torch.trainer.flash_checkpoint import distributed

    trainer, state, depth, per_step = ckpt_subject(
        trainer, state, batch, per_step, copies=2 if then else 1,
        max_layers=DIST_CKPT_LAYERS)
    payload = bench.state_nbytes(state) + sum(
        8 for _, leaf in flatten_with_path(state)
        if not isinstance(leaf, torch.Tensor))  # the ints: 0-d int64
    phase_t0 = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="dlrover_tpu_torch_dist_")
    scope = f"dist{os.getpid()}"
    want = {path: leaf.clone() if isinstance(leaf, torch.Tensor) else leaf
            for path, leaf in flatten_with_path(state)}
    record = dict(layers=depth, payload_bytes=payload)
    made = []

    def checkpointer(tag):
        with dist_persist(True):
            made.append(Checkpointer(ckpt_dir, scope=scope + tag,
                                     async_snapshot=False,
                                     device=trainer.device))
        return made[-1]

    try:
        ckpt = checkpointer("s")
        step = int(state.step)
        for label, save_step in (("full", step), ("differential", step + 1)):
            t0 = time.perf_counter()
            blocked = ckpt.save_checkpoint(save_step, state,
                                           StorageType.DISK, trainer=trainer)
            sealed = ckpt.wait_latest_checkpoint(timeout=900)
            total_s = time.perf_counter() - t0
            manifest = distributed.read_manifest(ckpt_dir, save_step) or {}
            host = manifest.get("hosts", {}).get("0", {})
            written = host.get("bytes_written", -1)
            reused = host.get("bytes_reused", -1)
            persist_s = total_s - blocked
            print(f"  {label} save of step {save_step}: sealed {sealed} "
                  f"(COMMITTED {distributed.read_committed_step(ckpt_dir)});"
                  f" blocking_save_s {blocked:.3f}, persist_s {persist_s:.3f}"
                  f" ({written / max(persist_s, 1e-9) / 1e9:.3f} GB/s "
                  f"written); bytes_written {written}, bytes_reused "
                  f"{reused} of the payload {payload}", flush=True)
            record[label] = dict(step=save_step, sealed=sealed,
                                 blocking_save_s=blocked,
                                 persist_s=persist_s, bytes_written=written,
                                 bytes_reused=reused)
            if not sealed or \
                    distributed.read_committed_step(ckpt_dir) != save_step:
                raise AssertionError(f"{label} save of step {save_step} did "
                                     "not seal")
            want_written = payload if label == "full" else 0
            if written != want_written or written + reused != payload:
                raise AssertionError(
                    f"{label} save wrote {written} and reused {reused} "
                    f"bytes; the payload is {payload}")
        fa.reset_launches()
        _, metrics = trainer.train_step(state, batch)
        uninterrupted = metrics["loss"].item()
        del state
        fresh = checkpointer("r")
        target = trainer.create_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, got = fresh.load_checkpoint(target, trainer=trainer)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        stats = fresh.engine.last_read_stats
        bad = [path for path, leaf in flatten_with_path(restored)
               if not (torch.equal(leaf, want[path])
                       if isinstance(leaf, torch.Tensor)
                       else leaf == want[path])]
        print(f"  restore of the sealed step {got} (a fresh scope, no shm): "
              f"{restore_s:.3f} s, bytes_read/bytes_total "
              f"{stats.get('bytes_read')}/{stats.get('bytes_total')} in "
              f"{stats.get('shards_fetched')} shard reads; "
              f"{len(want) - len(bad)} of {len(want)} leaves torch.equal to "
              "the state saved", flush=True)
        if got != step + 1 or bad or \
                len(flatten_with_path(restored)) != len(want):
            raise AssertionError(f"the restore gave step {got} (want "
                                 f"{step + 1}); leaves that differ: "
                                 f"{bad[:5]}")
        _, metrics = trainer.train_step(restored, batch)
        loss = metrics["loss"].item()
        launches = dict(fa.launches)
        print(f"  one step from the restored state: loss {loss!r}, the "
              f"uninterrupted step's {uninterrupted!r}; flash launches of "
              f"the 2 steps {launches}", flush=True)
        if not (math.isfinite(loss) and abs(loss - uninterrupted)
                <= RESTORED_LOSS_RTOL * abs(uninterrupted)):
            raise AssertionError(f"loss {loss} after the restore, "
                                 f"{uninterrupted} uninterrupted")
        if launches != {k: 2 * v for k, v in per_step.items()}:
            raise AssertionError(f"the 2 steps launched {launches}")
        record.update(restore_s=restore_s, read_stats=dict(stats),
                      loss_after_restore=loss,
                      loss_uninterrupted=uninterrupted)
        del restored
        print(f"  the phase took {time.perf_counter() - phase_t0:.1f} s",
              flush=True)
        if then is not None:
            then(trainer, ckpt_dir, step + 1, want, uninterrupted, per_step,
                 ckpt)
    finally:
        for c in made:
            c.engine.unlink_memory()
            c.close()
        want.clear()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return record


def peer_restore_phase(fa, batch, trainer, ckpt_dir, step, want,
                       uninterrupted, per_step, donor) -> dict:
    """The [peer restore] phase on [dist persist]'s trainer, its saved
    state ``want``, its sealed commit of ``step`` and its memory save of
    that step in ``donor``'s segment (module docstring); returns its JSON
    record."""
    import torch

    from dlrover_tpu_torch.common.pytree import flatten_with_path
    from dlrover_tpu_torch.trainer.flash_checkpoint import (
        Checkpointer,
        bench,
        peer_restore,
        snapshot,
    )

    phase_t0 = time.perf_counter()
    tag = f"pr{os.getpid()}"
    job = f"{tag}job"  # the broker's scope: the job both processes are in
    state_bytes = sum(t.numel() * t.element_size() for t in want.values()
                      if isinstance(t, torch.Tensor))
    check_shm(2 * state_bytes + 2 * CKPT_META_MARGIN,
              "a donor and a replacement segment")
    record = {"step": step}
    made, endpoint = [], None

    def recover_and_step(label, rung, assignment, plan=None):
        """The replacement (process 0 of 2, a Checkpointer of its own
        scope, its segment empty) runs the ladder into its engine's
        segment, as the engine's hook does, and restores from it:
        torch.equal to the saved state, then one step."""
        made.append(Checkpointer(ckpt_dir, scope=f"{tag}{rung}",
                                 async_snapshot=False, device=trainer.device))
        ckpt = made[-1]
        report = peer_restore.recover(
            scope=job, process_id=0, num_processes=2, shm=ckpt.engine._shm,
            checkpoint_dir=ckpt_dir, assignment=assignment, plan=plan,
            client=client)
        moved = report["bytes_peer"] + report["bytes_manifest"]
        equal = (snapshot.read_meta_bytes(ckpt.engine._shm) == donor_meta)
        if not report["filled"] or report["rung"] != rung or \
                moved != payload or report[f"bytes_{label}"] != payload \
                or not equal:
            raise AssertionError(f"the {rung} recovery reported {report} "
                                 f"(meta equal to the donor's: {equal})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, got = ckpt.load_checkpoint(trainer.create_state(),
                                             trainer=trainer)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bad = [path for path, leaf in flatten_with_path(restored)
               if not (torch.equal(leaf, want[path])
                       if isinstance(leaf, torch.Tensor)
                       else leaf == want[path])]
        if got != step or bad:
            raise AssertionError(f"{rung}: the restore gave step {got} "
                                 f"(want {step}); leaves that differ: "
                                 f"{bad[:5]}")
        fa.reset_launches()
        _, metrics = trainer.train_step(restored, batch)
        loss = metrics["loss"].item()
        launches = dict(fa.launches)
        del restored
        print(f"  {rung} rung: mttr_s {report['mttr_s']:.3f}, "
              f"peer_read_gbps {report['peer_read_gbps']:.3f}, bytes_peer "
              f"{report['bytes_peer']}, bytes_manifest "
              f"{report['bytes_manifest']} ({report['storage_reads']} shard "
              f"reads), the meta byte-equal to the donor's; the "
              f"Checkpointer's restore of the filled segment "
              f"{restore_s:.3f} s, {len(want)} leaves torch.equal; one step: "
              f"loss {loss!r} (uninterrupted {uninterrupted!r}), flash "
              f"launches {launches}", flush=True)
        if not (math.isfinite(loss) and abs(loss - uninterrupted)
                <= RESTORED_LOSS_RTOL * abs(uninterrupted)):
            raise AssertionError(f"{rung}: loss {loss} after the restore, "
                                 f"{uninterrupted} uninterrupted")
        if launches != per_step:
            raise AssertionError(f"{rung}: the step launched {launches}, "
                                 f"expected {per_step}")
        ckpt.engine.unlink_memory()
        return dict(report, restore_s=restore_s, loss_after_restore=loss,
                    launches=launches)

    try:
        # the donor (process 1 of 2): the memory save of the sealed step,
        # served on 127.0.0.1 and announced through the in-process broker
        meta = snapshot.read_snapshot_meta(donor.engine._shm)
        donor_meta = snapshot.read_meta_bytes(donor.engine._shm)
        payload = int(meta["payload_bytes"])
        if meta["step"] != step:
            raise AssertionError(f"the donor holds step {meta['step']}")
        endpoint = peer_restore.PeerServeEndpoint(
            0, scope=donor.engine._scope).start()
        client = peer_restore.LocalPeerClient()
        client.report_peer_announce(job, step, endpoint.addr,
                                    num_processes=2, process_id=1)
        print(f"  donor: the memory save of step {step} ({payload / 1e9:.3f}"
              f" GB payload, {len(meta['leaves'])} leaves) served on "
              f"{endpoint.addr}", flush=True)
        assignment = client.get_peer_assignment(job, process_id=0)
        record["peer"] = recover_and_step(
            "peer", "peer_shm", {"step": assignment.step,
                                 "donors": dict(assignment.donors)})

        # donorless: the same step from the sealed commit
        endpoint.stop()
        endpoint = None
        plan = [dict(leaf, shards=[dict(s) for s in leaf["shards"]])
                for leaf in meta["leaves"]]
        donor.engine.unlink_memory()
        record["manifest"] = recover_and_step(
            "manifest", "manifest", {"step": step, "donors": {}}, plan)
        record["recoveries_recorded"] = len(client.recoveries())
        t0 = time.perf_counter()
        record["bench"] = bench.peer_recovery_bench()
        print(f"  peer_recovery_bench() (8 MB, 4 local hosts): "
              f"{json.dumps(record['bench'])} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not record["bench"]["bit_exact"] or \
                record["bench"]["rung"] != "peer_shm":
            raise AssertionError(f"the bench reported {record['bench']}")
    finally:
        if endpoint is not None:
            endpoint.stop()
        for c in made:
            c.engine.unlink_memory()
            c.close()
    print(f"  the phase took {time.perf_counter() - phase_t0:.1f} s",
          flush=True)
    return record


def dist_bench_phase() -> dict:
    """The reference's bench of the distributed persist
    (trainer/flash_checkpoint/dist_bench.py) on this host, at
    DIST_BENCH_MB when the temp dir's disk and the host's RAM hold it;
    prints its DIST_CKPT_BENCH line."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.trainer.flash_checkpoint import dist_bench

    root = tempfile.gettempdir()
    disk = shutil.disk_usage(root).free
    ram = host_available_bytes()
    # the largest leg holds two steps' files and a joined copy per host
    need = 3 * DIST_BENCH_MB * (1 << 20)
    mb = DIST_BENCH_MB if min(disk, ram) > 4 * need else 64
    print(f"  {root}: {disk / 1e9:.1f} GB free; host RAM available "
          f"{ram / 1e9:.1f} GB; payload {mb} MB", flush=True)
    t0 = time.perf_counter()
    result = dist_bench.run(total_mb=mb, host_counts=(1, 2, 4))
    print(dist_bench.MARK + json.dumps(result), flush=True)
    print(f"  the bench took {time.perf_counter() - t0:.1f} s", flush=True)
    if not all(leg["sealed"] for leg in result["persist_scaling"]):
        raise AssertionError("a bench leg did not seal")
    if result["partial_read"]["read_fraction"] != 0.5:
        raise AssertionError(f"half-state read fraction "
                             f"{result['partial_read']['read_fraction']}")
    return result


def ring_edge_rows(block: int, rows: int = 64, seed: int = 0):
    """(rows, block) fp32 on the card: a zero block, exact .5 ties at
    scale 1 for int8 (max 127) and int4 (max 7), values all at +-max,
    a negative-only block, a block of one nonzero value, and seeded blocks
    over six decades of magnitude."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, block))
         * 10.0 ** rng.uniform(-4, 2, (rows, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] = np.arange(block) % 127 - 63 + 0.5
    x[1, 0] = 127.0
    x[2] = np.arange(block) % 14 - 7 + 0.5
    x[2, :2] = (7.0, -7.0)
    x[3] = np.where(np.arange(block) % 2, 3.0, -3.0)
    x[4] = -np.abs(x[4])
    x[5] = 0.0
    x[5, 7] = -2.5e-3
    return torch.from_numpy(x).cuda()


def ring_accum_inputs(fmt: str, nblk: int, block: int, seed: int = 1):
    """acc, codes and scales on the card for one arriving chunk; codes over
    their whole range (every nibble for int4), a zero scale, a zero acc
    row, and an int8 element whose sum needs one fused rounding."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((nblk, block)).astype(np.float32)
    qcols = block if fmt == "int8" else block // 2
    q = rng.integers(-127 if fmt == "int8" else -128, 128,
                     (nblk, qcols)).astype(np.int8)
    s = rng.uniform(1e-4, 1.0, (nblk, 1)).astype(np.float32)
    s[min(1, nblk - 1)] = 0.0
    acc[0, 1:] = 0.0
    if fmt == "int8":
        # 1 + 59 * 9099507 * 2**-53 = 1 + 2**-24 + 2**-53: just above a
        # midpoint, which a sum rounded twice would miss
        acc[0, 0], q[0, 0], s[0] = 1.0, 59, np.float32(9099507 * 2.0 ** -53)
    return (torch.from_numpy(acc).cuda(), torch.from_numpy(q).cuda(),
            torch.from_numpy(s).cuda())


def max_abs(got, want) -> float:
    return (got.double() - want.double()).abs().max().item()


def check_ring_kernels(rrs, shapes, errors):
    """Each ring kernel against its plain version on the same tensors,
    torch.equal (raises on any difference); ``shapes`` are (world, nblk,
    block) encode inputs, and the accumulate takes one chunk of nblk
    rows.  ``errors[name]`` keeps the largest |kernel - plain| over every
    output compared."""
    import torch

    for world, nblk, block in shapes:
        for fmt in ("int8", "int4"):
            if nblk * world <= 64:
                x = ring_edge_rows(block, world * nblk).reshape(world, nblk,
                                                                 block)
            else:
                g = torch.Generator(device="cuda").manual_seed(nblk)
                x = torch.randn(world, nblk, block, device="cuda",
                                generator=g) * 1e-3
            got = rrs.fused_quantize(x, fmt)
            want = rrs.encode_plain(x.reshape(-1, block), fmt)
            name = "q8_encode" if fmt == "int8" else "q4_encode"
            for part, g_, w_ in zip(("codes", "scales", "dequant"), got,
                                    want):
                w_ = w_.reshape(g_.shape)
                diff = max_abs(g_, w_)
                errors[name] = max(errors.get(name, 0.0), diff)
                if not torch.equal(g_, w_):
                    raise AssertionError(
                        f"{name} {part} differ from the plain version at "
                        f"{(world, nblk, block)}: max abs {diff}")
            acc, q, s = ring_accum_inputs(fmt, nblk, block)
            name = "q8_accum" if fmt == "int8" else "q4_accum"
            want = rrs.accum_plain(acc, q, s, fmt)
            got = rrs.fused_dequant_add(acc, q, s, fmt)
            inplace = acc.clone()
            rrs.fused_dequant_add(inplace, q, s, fmt, out=inplace)
            torch.cuda.synchronize()
            for variant, g_ in (("out", got), ("in place", inplace)):
                diff = max_abs(g_, want)
                errors[name] = max(errors.get(name, 0.0), diff)
                if not torch.equal(g_, want):
                    raise AssertionError(
                        f"{name} ({variant}) differs from the plain version "
                        f"at nblk={nblk} block={block}: max abs {diff}")
            print(f"  (world, nblk, block)={(world, nblk, block)} {fmt}: "
                  f"encode and accumulate (out, in place) equal to plain")


def ring_bytes(name: str, world: int, nblk: int, block: int) -> int:
    """Bytes one launch must move: each input read once, each output
    written once (encode over (world, nblk, block), accumulate over one
    (nblk, block) chunk)."""
    code_bytes = 1.0 if name.startswith("q8") else 0.5
    if name.endswith("encode"):
        n, rows = world * nblk * block, world * nblk
        return int(n * (4 + code_bytes + 4) + 4 * rows)
    n = nblk * block
    return int(n * (4 + code_bytes + 4) + 4 * nblk)


def time_ring_kernels(rrs, world: int, nblk: int, block: int):
    """Per-launch time of each ring kernel and its plain version at one
    bucket shape, beside the bound."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(world, nblk, block, device="cuda", generator=g)
    q8, s8, _ = rrs.fused_quantize(x, "int8")
    q4, s4, _ = rrs.fused_quantize(x, "int4")
    acc = torch.randn(nblk, block, device="cuda", generator=g)
    runs = {
        "q8_encode": (lambda: rrs.fused_quantize(x, "int8"),
                      lambda: rrs.encode_plain(x.reshape(-1, block), "int8")),
        "q4_encode": (lambda: rrs.fused_quantize(x, "int4"),
                      lambda: rrs.encode_plain(x.reshape(-1, block), "int4")),
        "q8_accum": (lambda: rrs.fused_dequant_add(acc, q8[0], s8[0], "int8",
                                                   out=acc),
                     lambda: rrs.accum_plain(acc, q8[0], s8[0], "int8")),
        "q4_accum": (lambda: rrs.fused_dequant_add(acc, q4[0], s4[0], "int4",
                                                   out=acc),
                     lambda: rrs.accum_plain(acc, q4[0], s4[0], "int4")),
    }
    timings = {}
    for name, (kernel, plain) in runs.items():
        ms = cuda_time_ms(kernel, iters=20)
        plain_ms = cuda_time_ms(plain, iters=3, warmup=1)
        nbytes = ring_bytes(name, world, nblk, block)
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by="bytes", library_ms=None)
        print(f"  {name} at (world, nblk, block)={(world, nblk, block)}: "
              f"{ms:.4f} ms  bound {b_ms:.4f} ms (bytes, "
              f"{nbytes / 1e6:.2f} MB)  plain {plain_ms:.4f} ms")
    return timings


def check_ring_add(rrs, errors):
    """The ring_pallas hop's add kernel against its plain version, out of
    place and in place, torch.equal at every width."""
    import torch

    for width in ADD_WIDTHS:
        g = torch.Generator(device="cuda").manual_seed(width)
        a = torch.randn(width, device="cuda", generator=g)
        b = torch.randn(width, device="cuda", generator=g) * 1e3
        want = rrs.add_plain(a, b)
        got = rrs.ring_add(a, b)
        inplace = a.clone()
        rrs.ring_add(inplace, b, out=inplace)
        torch.cuda.synchronize()
        for variant, g_ in (("out", got), ("in place", inplace)):
            diff = max_abs(g_, want)
            errors["ring_add"] = max(errors.get("ring_add", 0.0), diff)
            if not torch.equal(g_, want):
                raise AssertionError(f"ring_add ({variant}) differs from the "
                                     f"plain version at width {width}: max "
                                     f"abs {diff}")
    print(f"  widths {ADD_WIDTHS}: out of place and in place equal to plain")


def rdma_inputs(world: int, width: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(world, world, width, device="cuda", generator=g)


def check_rdma_ring(rdma, errors):
    """The one-kernel ring with W ranks on the card against its plain
    version at every shape (one set of windows per W, its widths in turn);
    then its one-card path, counted; returns that path's launch count."""
    import torch

    for world in sorted({w for w, _ in RDMA_SHAPES}):
        with rdma.OneCardWindows("cuda", world) as windows:
            for width in [n for w, n in RDMA_SHAPES if w == world]:
                xs = rdma_inputs(world, width, seed=world * 7 + width)
                want = rdma.rdma_ring_plain(xs)
                got = rdma.rdma_ring_one_card(xs, windows)
                windows.check()
                diff = max_abs(got, want)
                errors["rdma_ring"] = max(errors.get("rdma_ring", 0.0), diff)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"rdma_ring differs from the plain version at "
                        f"W={world} width={width}: max abs {diff}")
                print(f"  W={world} width={width}: equal to plain")
                del xs, want, got
            print(f"  W={world}: windows of {windows.window_bytes} B a rank "
                  f"({windows.ctas} CTAs x {windows.slots} slots of "
                  f"{rdma.CHUNK_ELEMS * 4} B)")
    world = RDMA_REUSE_WORLD
    inputs = [rdma_inputs(world, width, seed=100 + k)
              for k, width in enumerate(RDMA_REUSE_WIDTHS)]
    wants = [rdma.rdma_ring_plain(xs) for xs in inputs]
    with rdma.OneCardWindows(inputs[0].device, world) as windows:
        torch.cuda.synchronize()
        rdma.reset_launches()
        outs = [rdma.rdma_ring_one_card(inputs[k % 3], windows)
                for k in range(RDMA_REUSE_CALLS)]
        launches = rdma.launches["rdma_ring"]
        windows.check()
    for k, got in enumerate(outs):
        diff = max_abs(got, wants[k % 3])
        errors["rdma_ring"] = max(errors["rdma_ring"], diff)
        if not torch.equal(got, wants[k % 3]):
            raise AssertionError(f"rdma_ring call {k} of {RDMA_REUSE_CALLS} "
                                 f"back to back differs from plain: max abs "
                                 f"{diff}")
    if launches != RDMA_REUSE_CALLS:
        raise AssertionError(f"{RDMA_REUSE_CALLS} calls launched the rdma "
                             f"ring {launches} times")
    print(f"  one-card path: {RDMA_REUSE_CALLS} calls back to back at "
          f"W={world} on one set of windows, widths {RDMA_REUSE_WIDTHS} in "
          f"turn, launches {launches}, every output equal to plain")
    return launches


def check_rdma_timeout(rdma):
    """A stuck peer gives an error, never a hang: skipping generations on
    the one-card windows leaves every CTA's entry barrier short of its
    count, so each wait runs out and check() raises.  A second call queued
    on the broken windows leaves at once: both take one timeout."""
    import torch

    xs = rdma_inputs(2, 128, seed=9)
    with rdma.OneCardWindows(xs.device, 2,
                             timeout_s=RDMA_TIMEOUT_S) as windows:
        rdma.rdma_ring_one_card(xs, windows)
        windows.check()
        windows.generation += 5
        t0 = time.perf_counter()
        rdma.rdma_ring_one_card(xs, windows)
        rdma.rdma_ring_one_card(xs, windows)
        try:
            windows.check()
        except RuntimeError as e:
            took = time.perf_counter() - t0
            if "entry barrier" not in str(e) or took > 1.75 * RDMA_TIMEOUT_S:
                raise AssertionError(f"unexpected timeout report after "
                                     f"{took:.2f} s: {e}")
            print(f"  peers that never arrive (two calls queued, timeout "
                  f"{RDMA_TIMEOUT_S} s): raised after {took:.2f} s: "
                  f"{str(e)[:160]}")
        else:
            raise AssertionError("a call whose peers never arrive passed")
    with rdma.OneCardWindows(xs.device, 2) as windows:
        got = rdma.rdma_ring_one_card(xs, windows)
        windows.check()
    if not torch.equal(got, rdma.rdma_ring_plain(xs)):
        raise AssertionError("the call on fresh windows is wrong")
    print("  a call on fresh windows equals plain")


def time_rdma_ring(rdma):
    """The one-card ring's time at W=4 and each of RDMA_TIME_WIDTHS (the
    kernel alone: the wrapper only launches), beside its bound, its plain
    version and torch.sum over the ranks, and its windows' bytes.  The
    first width's numbers are the kernel's record; each width's are under
    ``widths``."""
    import torch

    world = 4
    timed = {}
    with rdma.OneCardWindows("cuda", world) as windows:
        for width in RDMA_TIME_WIDTHS:
            xs = rdma_inputs(world, width, seed=5)
            iters = max(10, min(200, 2 * 10 ** 8 // xs.numel()))
            ms = cuda_time_ms(lambda: rdma.rdma_ring_one_card(xs, windows),
                              iters=iters)
            windows.check()
            plain_ms = cuda_time_ms(lambda: rdma.rdma_ring_plain(xs),
                                    iters=3, warmup=1)
            library_ms = cuda_time_ms(lambda: torch.sum(xs, 0), iters=iters)
            # the function reads every rank's (W, width) buffer once and
            # writes every rank's row once
            nbytes = (world + 1) * world * width * 4
            b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            # the ring also writes each hop's packet and reads it back: in
            # L2 when the slots stay there, through HBM when they did not
            packets = 2 * (world - 1) * world * width * 4
            print(f"  rdma_ring_one_card at W={world} width={width}: "
                  f"{ms:.4f} ms  bound {b_ms:.4f} ms (bytes, "
                  f"{nbytes / 1e9:.4f} GB)  plain {plain_ms:.4f} ms  "
                  f"torch.sum(xs, 0) {library_ms:.4f} ms; the packets' "
                  f"traffic {packets / 1e9:.4f} GB more "
                  f"({(nbytes + packets) / PEAK_BYTES_PER_S * 1e3:.4f} ms at "
                  f"3.35 TB/s if it went to HBM); {iters} calls")
            timed[width] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                library_ms=library_ms)
            del xs
        print(f"  windows: {windows.window_bytes} B a rank, "
              f"{world * windows.window_bytes} B for the {world} ranks "
              f"({windows.ctas} CTAs x {windows.slots} slots of "
              f"{rdma.CHUNK_ELEMS * 4} B per rank), whatever the width")
    first = timed[RDMA_TIME_WIDTHS[0]]
    return dict(first, bound_by="bytes",
                window_bytes=world * windows.window_bytes,
                widths={str(w): t for w, t in timed.items()})


def time_in_turns(fns: dict, iters: int = 20) -> dict:
    """{name: [ms, ms]}: each function timed twice, in turns (a, b, ...,
    b, a), so that a drift of the card's clock reaches every one alike."""
    names = list(fns)
    readings = {name: [] for name in names}
    for name in names + names[::-1]:
        readings[name].append(cuda_time_ms(fns[name], iters=iters))
    return readings


def time_hop_add(rrs, width: int):
    """The ring_pallas hop's add at one bucket row beside its bound, its
    plain version and torch.add, like for like: in place, as the ring runs
    it, beside torch.add(a, b, out=a), and out of place beside
    torch.add(a, b), each pair in turns."""
    import torch

    a = torch.randn(width, device="cuda")
    b = torch.randn(width, device="cuda")
    pairs = {
        "in place": {
            "ring_add(a, b, out=a)": lambda: rrs.ring_add(a, b, out=a),
            "torch.add(a, b, out=a)": lambda: torch.add(a, b, out=a)},
        "out of place": {
            "ring_add(a, b)": lambda: rrs.ring_add(a, b),
            "torch.add(a, b)": lambda: torch.add(a, b)},
    }
    means = {}
    for label, fns in pairs.items():
        readings = time_in_turns(fns)
        (kernel, k_ms), (library, l_ms) = readings.items()
        means[label] = (statistics.mean(k_ms), statistics.mean(l_ms))
        print(f"  {label} at width {width}: {kernel} {k_ms[0]:.4f}, "
              f"{k_ms[1]:.4f} ms; {library} {l_ms[0]:.4f}, {l_ms[1]:.4f} ms; "
              f"kernel / torch {means[label][0] / means[label][1]:.3f}")
    plain_ms = cuda_time_ms(lambda: rrs.add_plain(a, b), iters=20)
    b_ms = 12 * width / PEAK_BYTES_PER_S * 1e3
    print(f"  ring_add bound {b_ms:.4f} ms (bytes), plain {plain_ms:.4f} ms")
    return dict(ms=means["in place"][0], plain_ms=plain_ms, bound_ms=b_ms,
                bound_by="bytes", library_ms=means["in place"][1],
                library_call="torch.add(a, b, out=a)",
                ms_out_of_place=means["out of place"][0],
                library_ms_out_of_place=means["out of place"][1])


def peer_window_leg():
    """4 gloo ranks on the card build a PeerWindow and move one row to each
    right neighbour through it (phase 8)."""
    from dlrover_tpu_torch.parallel import dp_workers, process_group

    t0 = time.perf_counter()
    ranks = process_group.spawn(
        dp_workers.peer_window_worker, DP_WORLD,
        (dict(width=PEER_WINDOW_WIDTH, seed=7),), backend="gloo",
        device="cuda", timeout_s=120.0)
    for r in ranks:
        print(f"  rank {r['rank']}: window {r['window_bytes']} B, "
              f"{r['ctas']} CTAs; its slots equal to the left neighbour's "
              f"row of {r['width']}: {r['equal']} (max abs "
              f"{r['max_abs_err']})")
        if not r["equal"]:
            raise AssertionError(f"rank {r['rank']}'s slot does not hold its "
                                 "left neighbour's row")
    print(f"  {DP_WORLD} processes, IPC-opened windows, "
          f"{time.perf_counter() - t0:.1f} s with spawn")


def expected_ring_launches(mode: str, transport: str, widths,
                           names, chains: int = 0) -> dict:
    """The ring kernels' launches one dp step must make on each rank,
    where the comm probe ran each bucket's chain ``chains`` times more in
    that step (each chain the same reduce-scatter as the step's)."""
    want = {name: 0 for name in names}
    n_buckets = len(widths) * (1 + chains)
    if mode.startswith(("int8", "int4", "blockwise")):
        enc, acc = (("q8_encode", "q8_accum") if mode.startswith("int8")
                    else ("q4_encode", "q4_accum"))
        want[enc], want[acc] = n_buckets, n_buckets * (DP_WORLD - 1)
    elif transport == "ring_pallas":
        # the hop add runs where the width meets the tier's tiling rule;
        # the other buckets take the ring's plain add
        want["add"] = (sum(w % 1024 == 0 for w in widths) * (DP_WORLD - 1)
                       * (1 + chains))
    return want


def probe_chains(name: str, step: int) -> int:
    """The times the comm probe ran each bucket's chain in step ``step``
    (0-based) of the dp leg's run ``name``: the trainer counts its digest
    steps from its second step, and probes every DP_PROBE_EVERY of them."""
    if name != DP_PROBE_RUN or step == 0 or step % DP_PROBE_EVERY:
        return 0
    return DP_PROBE_CHAINS


def dp_leg():
    """The 4-rank data-parallel leg on the one card (phase 9)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from dlrover_tpu_torch.models.llama import LlamaConfig
    from dlrover_tpu_torch.parallel import dp_workers, process_group

    ids = np.random.default_rng(0).integers(0, 32000,
                                            size=(DP_WORLD, TRAIN_S + 1))
    spec = dict(
        preset="llama2_1b",
        model=dict(num_layers=DP_LAYERS, attention_impl="flash",
                   max_seq_len=TRAIN_S),
        state_dict=None, seed=0,
        batch={"input_ids": ids[:, :-1].astype(np.int32),
               "labels": ids[:, 1:].astype(np.int32)},
        optimizer=dict(peak_lr=3e-4, warmup_steps=10, total_steps=10_000,
                       grad_clip_norm=None, moment_dtype=torch.bfloat16),
        grads_dtype=torch.bfloat16,
        runs=[dict(name=name, steps=steps,
                   policy=dict(mode=mode, bucket_mb=DP_BUCKET_MB,
                               clip_norm=1.0, transport=transport))
              for name, mode, transport, steps in DP_RUNS],
    )
    root = tempfile.mkdtemp(prefix="dp_ckpt_")
    probed = [r for r in spec["runs"] if r["name"] == DP_PROBE_RUN][0]
    probed["env"] = dict(
        SCOPES_ON, DLROVER_TPU_COMM_PROBE_EVERY=str(DP_PROBE_EVERY),
        DLROVER_TPU_COMM_BUCKET_PROBE="1",
        DLROVER_TPU_RUNTIME_METRICS_PATH=os.path.join(
            root, "telemetry", "runtime_metrics.json"))
    # the first run (int8_sharded over ring_pallas_q) ends with a flash
    # checkpoint of every rank's state, residuals included
    first = spec["runs"][0]
    # [replica]'s runs go with load_state's in its spawn of 2 ranks
    lose = replica_runs(root)
    first["save"] = dict(dir=root, scope=f"dp{os.getpid()}")
    # and again under the distributed persist, into a directory of its own
    first["dist_save"] = dict(dir=os.path.join(root, "dist"),
                              scope=f"dp{os.getpid()}dist")
    check_shm(DP_WORLD * DP_CKPT_BYTES_PER_PARAM * llama_param_count(
        LlamaConfig.llama2_1b(num_layers=DP_LAYERS)) + CKPT_META_MARGIN,
        "the dp leg's checkpoint")
    print(f"  {DP_WORLD} rank processes share the one card over a gloo "
          f"group: every exchange is host-staged (device -> host -> "
          f"device); llama2_1b at full width, {DP_LAYERS} layers, B=1 per "
          f"rank, S={TRAIN_S}, bucket {DP_BUCKET_MB} MB; runs "
          f"{[(name, transport) for name, _, transport, _ in DP_RUNS]}",
          flush=True)
    t0 = time.perf_counter()
    try:
        ranks = process_group.spawn(dp_workers.train_worker, DP_WORLD,
                                    (spec,), backend="gloo", device="cuda",
                                    timeout_s=DP_TIMEOUT_S)
        print(f"  the leg took {time.perf_counter() - t0:.1f} s with spawn "
              "and model set-up", flush=True)
        records = {name: [r["runs"][name] for r in ranks]
                   for name, _, _, _ in DP_RUNS}
        resume, resumed = dp_resume(spec, first, records[first["name"]],
                                    lose)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary = records["int8_sharded"][0]["summary"]
    widths = summary["bucket_widths"]
    print(f"  buckets: {len(widths)}, signature {summary['signature']}, row "
          f"widths {min(widths)}..{max(widths)}")
    names = sorted(records["int8_sharded"][0]["launches"][0])
    launches = {name: 0 for name in names}
    flash_per_step = {"flash_fwd": 2 * DP_LAYERS, "flash_bwd_dq": DP_LAYERS,
                      "flash_bwd_dkv": DP_LAYERS}
    exact_loss = records["exact_sharded"][0]["loss"]
    for name, mode, transport, steps in DP_RUNS:
        recs = records[name]
        for rec in recs:
            if rec["summary"]["signature"] != summary["signature"]:
                raise AssertionError(f"{name}: ranks derived different "
                                     "bucket layouts")
            if rec["params_agree"] != [True] * steps:
                raise AssertionError(f"{name}: params not bit-identical "
                                     f"across ranks: {rec['params_agree']}")
            for step, counts in enumerate(rec["launches"]):
                want = expected_ring_launches(mode, transport, widths, names,
                                              probe_chains(name, step))
                if counts != want:
                    raise AssertionError(f"{name} step {step} launched "
                                         f"{counts}, expected {want}")
                for kernel in launches:
                    launches[kernel] += counts[kernel]
            for step, counts in enumerate(rec["flash_launches"]):
                if counts != flash_per_step:
                    raise AssertionError(f"{name} step {step} launched the "
                                         f"flash kernels {counts}, expected "
                                         f"{flash_per_step}")
        resolved = recs[0]["summary"]["transport_resolved"]
        if transport == "ring_pallas" and resolved != ["ring", "ring_pallas"]:
            raise AssertionError(f"{name} resolved to {resolved}, expected "
                                 "ring_pallas for the 1024-aligned buckets "
                                 "and ring for the others")
        loss = recs[0]["loss"]
        if not all(math.isfinite(v) for v in loss + recs[0]["grad_norm"]):
            raise AssertionError(f"{name}: non-finite loss or grad norm")
        if abs(loss[0] - exact_loss[0]) > DP_STEP0_RTOL * abs(exact_loss[0]):
            raise AssertionError(f"{name}: step-0 loss {loss[0]} differs "
                                 f"from exact_sharded's {exact_loss[0]}")
        n = min(len(loss), len(exact_loss))
        rel = max(abs(a - b) / abs(b) for a, b in zip(loss[:n],
                                                      exact_loss[:n]))
        tol = (EXACT_RING_RTOL if mode == "exact_sharded"
               else DP_LOSS_RTOL.get(mode.split("_")[0], 0.0))
        if rel > tol:
            raise AssertionError(f"{name}: loss {loss} is {rel:.2e} "
                                 f"relative from exact_sharded's "
                                 f"{exact_loss} (tol {tol})")
        timed = recs[0]["step_s"][1:] if name == "int8_sharded" else []
        peaks = [r["peak_mem_bytes"] / 2**30 for r in recs]
        ring_per_step = {k: v for k, v in recs[0]["launches"][-1].items()
                         if v}
        print(f"  {name}: transports {resolved}; losses "
              f"{[round(v, 5) for v in loss]} grad norms "
              f"{[round(v, 4) for v in recs[0]['grad_norm']]}; step s "
              f"{[round(v, 3) for v in recs[0]['step_s']]}"
              + (f" (timed mean {sum(timed) / len(timed):.3f})"
                 if timed else "")
              + f"; max rel loss vs exact {rel:.2e}; per-rank peak GiB "
              f"{[round(p, 2) for p in peaks]}; launches per step "
              f"{ring_per_step} {recs[0]['flash_launches'][-1]}")
    print("  params bit-identical across ranks after every step; step "
          "times are for the record only (4 processes time-slice the card, "
          "the exchange goes through the host)")
    probe_launches = check_dp_probe(records[DP_PROBE_RUN], widths, names)
    return launches, widths, resume, resumed, probe_launches


def check_dp_probe(recs, widths, names) -> dict:
    """The dp leg's probed run: each rank's fabric digest (the latency
    and bandwidth probes over the dp group) and each bucket's chain row,
    all finite and > 0; the four digest files folded by the port's merge
    rules (latency max, bandwidth min).  Returns the ring kernels'
    launches the chains added, over every rank."""
    from dlrover_tpu_torch.observability import commscope, jitscope, memscope

    mode, transport = [(m, t) for n, m, t, _ in DP_RUNS
                       if n == DP_PROBE_RUN][0]
    probes = sum(probe_chains(DP_PROBE_RUN, s) > 0
                 for s in range(len(recs[0]["launches"])))
    merged = {}
    for rank, rec in enumerate(recs):
        digest, rows = rec["digest"], rec["comm_buckets"]
        lat, bw = digest["fxl_dp"], digest["fxb_dp"]
        print(f"  {DP_PROBE_RUN} rank {rank}: fxl_dp {lat} us, fxb_dp {bw} "
              f"GB/s (probes over the gloo dp group, host-staged)")
        if len(rows) != len(widths) * probes:
            raise AssertionError(f"rank {rank}: {len(rows)} bucket chain "
                                 f"rows, expected {len(widths) * probes}")
        values = [lat, bw] + [r["chain_ms"] for r in rows] + [
            r["gbps"] for r in rows]
        if not all(math.isfinite(v) and v > 0 for v in values):
            raise AssertionError(f"rank {rank}: a probe or chain value is "
                                 f"not finite and > 0: {values}")
        if {r["transport"] for r in rows} != {transport}:
            raise AssertionError(f"rank {rank}: chains ran over "
                                 f"{sorted({r['transport'] for r in rows})}")
        for merge in (memscope.merge_digest, jitscope.merge_digest,
                      commscope.merge_digest):
            merge(merged, digest)
    for i, row in enumerate(recs[0]["comm_buckets"]):
        print(f"    bucket {i:2d}: {row['transport']} width {row['width']} "
              f"wire_bytes {row['wire_bytes']} chain_ms "
              f"{[r['comm_buckets'][i]['chain_ms'] for r in recs]} gbps "
              f"{[r['comm_buckets'][i]['gbps'] for r in recs]}")
    lats = [r["digest"]["fxl_dp"] for r in recs]
    bws = [r["digest"]["fxb_dp"] for r in recs]
    if merged["fxl_dp"] != max(lats) or merged["fxb_dp"] != min(bws):
        raise AssertionError(f"merged fxl_dp {merged['fxl_dp']} / fxb_dp "
                             f"{merged['fxb_dp']}, ranks {lats} / {bws}")
    print(f"  the {len(recs)} digest files merged: "
          f"{json.dumps(merged, sort_keys=True)}")
    base = expected_ring_launches(mode, transport, widths, names)
    with_chains = expected_ring_launches(mode, transport, widths, names,
                                         DP_PROBE_CHAINS)
    return {k: len(recs) * probes * (with_chains[k] - base[k]) for k in names}


def replica_runs(root: str) -> list:
    """[replica]'s two runs of ``dp_workers.train_worker`` (module
    docstring), each losing a rank's snapshot after one step: the replica
    pass on the dp leg's first run, the peer pass on the replicated exact
    sync, whose segments are the same on every rank (a replacement's peer
    fill is its donor's shard set, as in the reference: a ZeRO-1 quarter
    or a residual row no peer holds).  Their directories go under
    ``root``."""
    from dlrover_tpu_torch.models.llama import LlamaConfig

    _, mode, transport, _ = DP_RUNS[0]
    policies = {"replica": dict(mode=mode, transport=transport),
                "peer": dict(mode="exact")}
    # each rank's segment and, under replicas, its backup of its
    # predecessor's
    check_shm(2 * REPLICA_WORLD * (DP_CKPT_BYTES_PER_PARAM * llama_param_count(
        LlamaConfig.llama2_1b(num_layers=DP_LAYERS)) + CKPT_META_MARGIN),
        "the replica leg's segments and backups")
    return [dict(name=kind, steps=REPLICA_STEPS,
                 policy=dict(policies[kind], bucket_mb=DP_BUCKET_MB,
                             clip_norm=1.0),
                 lose=dict(dir=os.path.join(root, kind),
                           scope=f"rep{os.getpid()}{kind}", mode=kind))
            for kind in ("replica", "peer")]


def check_replica(ranks) -> dict:
    """[replica]'s checks on the ranks that ran ``replica_runs``; returns
    the flash and ring kernels' launches over every rank's steps after the
    restores."""
    name, _, transport, _ = DP_RUNS[0]
    print(f"  {REPLICA_WORLD} rank processes share the one card over a gloo "
          f"group: llama2_1b at full width, {DP_LAYERS} layers, S={TRAIN_S};"
          f" the replica pass {name} over {transport}, the peer pass exact "
          "(replicated)", flush=True)
    flash_per_step = {"flash_fwd": 2 * DP_LAYERS, "flash_bwd_dq": DP_LAYERS,
                      "flash_bwd_dkv": DP_LAYERS}
    launches = dict(flash_per_step, **ranks[0]["runs"]["replica"]
                    ["launches"][0])
    launches = dict.fromkeys(launches, 0)
    lost = REPLICA_WORLD - 1
    for kind in ("replica", "peer"):
        for rank, r in enumerate(ranks):
            c = r["runs"][kind]["lost"]
            ex = c["exchange"]
            rep = c["recovery"]
            if c["restored_step"] != c["step"] or not c["equal"] or \
                    c["lost"] != (rank == lost):
                raise AssertionError(f"{kind} rank {rank}: restored step "
                                     f"{c['restored_step']} (saved "
                                     f"{c['step']}), torch.equal "
                                     f"{c['equal']}, recovery {rep}")
            print(f"  {kind} rank {rank}{' (lost)' if c['lost'] else ''}: "
                  f"step {c['step']} blocking_save_s "
                  f"{c['blocking_save_s']:.4f} (paths {c['save_paths']}; "
                  f"device to host / shm write "
                  f"{[round(v, 3) for v in c['sync_phases'].values()]} s)"
                  + (f", replica exchange {ex['seconds']:.3f} s sending "
                     f"{ex['sent']} bytes, receiving {ex['received']} in "
                     f"{ex['rounds']} rounds of {ex['chunk']}" if ex else "")
                  + f"; restore_s {c['restore_s']:.3f}, step "
                  f"{c['restored_step']}, torch.equal {c['equal']}"
                  + (f"; recovery rung {rep['rung']}, mttr_s "
                     f"{rep['mttr_s']:.3f}, peer_read_gbps "
                     f"{rep['peer_read_gbps']:.3f}, bytes_peer "
                     f"{rep['bytes_peer']}" if rep else
                     "; fetched 0 bytes" if kind == "peer" else "")
                  + f"; next loss {c['next']['loss'][0]:.6f}, after the "
                  f"restore {c['restored']['loss'][0]:.6f}; launches "
                  f"{c['restored']['launches'][0]} "
                  f"{c['restored']['flash_launches'][0]}", flush=True)
            want, loss = c["next"]["loss"][0], c["restored"]["loss"][0]
            if not math.isfinite(loss) or \
                    abs(loss - want) > RESTORED_LOSS_RTOL * abs(want):
                raise AssertionError(f"{kind} rank {rank}: the step after "
                                     f"the restore lost {loss}, the "
                                     f"uninterrupted step {want}")
            counts = c["restored"]["flash_launches"][0]
            ring = c["restored"]["launches"][0]
            if counts != flash_per_step or \
                    ring != c["next"]["launches"][0] or \
                    any(ring.values()) != (kind == "replica"):
                raise AssertionError(
                    f"{kind} rank {rank}: the step after the restore "
                    f"launched {counts} {ring}, the uninterrupted step "
                    f"{c['next']['flash_launches'][0]} "
                    f"{c['next']['launches'][0]}")
            for k in launches:
                launches[k] += counts.get(k, 0) + ring.get(k, 0)
            if kind == "replica":
                if c["save_paths"] != [(c["step"], "sync")] or \
                        not ex or ex["received"] <= 0 or rep:
                    raise AssertionError(f"replica rank {rank}: paths "
                                         f"{c['save_paths']}, exchange {ex}")
            elif rank == lost:
                if not rep or rep["rung"] != "peer_shm" or \
                        not rep["filled"] or rep["storage_reads"]:
                    raise AssertionError(f"peer rank {rank}: recovery {rep}")
            elif rep:
                raise AssertionError(f"peer rank {rank} is a survivor and "
                                     f"fetched: {rep}")
    return launches


def dp_resume(spec, first, saved_recs, more_runs=()) -> tuple:
    """The dp leg's checkpoint: every rank's restores at its own degree
    (``check_ckpt_leg``: torch.equal, the next step's loss and launches),
    then DP_RESUME_WORLD new ranks restore it from storage with
    ``Trainer.load_state`` and take one step of the same policy.  Their
    residuals must sum to the residuals saved (EF_SUM_RTOL of the saved
    residuals' norm, through ``dp_workers.ef_digest``'s projections), the
    leaves the saving degree did not quantize must be zero, the loss
    finite, and the int8 encode and accumulate kernels must launch as the
    new degree's buckets need.  The spawn runs ``more_runs`` after that
    one.  Returns the ring kernels' launches of the step after the restore
    at the new degree, and the spawn's ranks' records."""
    from dlrover_tpu_torch.parallel import dp_workers, process_group

    saved = [r["ckpt"] for r in saved_recs]
    flash_per_step = {"flash_fwd": 2 * DP_LAYERS, "flash_bwd_dq": DP_LAYERS,
                      "flash_bwd_dkv": DP_LAYERS}
    dist_saved = [r["dist_ckpt"] for r in saved_recs]
    check_ckpt_leg(first["name"], saved, flash_per_step,
                   dict.fromkeys(flash_per_step, 0))
    check_ckpt_leg(f"{first['name']} (dist persist)", dist_saved,
                   flash_per_step, dict.fromkeys(flash_per_step, 0))
    check_dist_writes(first["name"], dist_saved)
    for c in saved + dist_saved:
        for source in ("shm", "storage"):
            if c[source]["launches"] != c["next"]["launches"]:
                raise AssertionError(
                    f"the step after the {source} restore launched "
                    f"{c[source]['launches']}, the uninterrupted step "
                    f"{c['next']['launches']}")
    run = dict(first, name="int8_resume", steps=1,
               resume=dict(dir=first["save"]["dir"],
                           scope=first["save"]["scope"] + "r"))
    del run["save"], run["dist_save"]
    t0 = time.perf_counter()
    ranks = process_group.spawn(
        dp_workers.train_worker, DP_RESUME_WORLD,
        (dict(spec, runs=[run, *more_runs]),), backend="gloo",
        device="cuda", timeout_s=DP_TIMEOUT_S)
    recs = [r["runs"]["int8_resume"] for r in ranks]
    ring_launches = dict.fromkeys(recs[0]["launches"][0], 0)
    widths = recs[0]["summary"]["bucket_widths"]
    want = {k: 0 for k in recs[0]["launches"][0]}
    want["q8_encode"] = len(widths)
    want["q8_accum"] = len(widths) * (DP_RESUME_WORLD - 1)
    before, after = {}, {}
    for c in saved:
        for leaf, (proj, sq) in c["ef_digest"].items():
            p, n = before.get(leaf, (0.0, 0.0))
            before[leaf] = (p + proj, n + math.sqrt(sq))
    for r in recs:
        for leaf, (proj, _) in r["ef_digest"].items():
            after[leaf] = after.get(leaf, 0.0) + proj
    worst = 0.0
    for leaf, total in after.items():
        proj, norm = before.get(leaf, (0.0, 0.0))
        if leaf not in before and total != 0.0:
            raise AssertionError(f"{leaf}: no residual was saved, the "
                                 f"restore gave one ({total})")
        if leaf in before:
            worst = max(worst, abs(total - proj) / max(norm, 1e-30))
    print(f"  load_state at dp={DP_RESUME_WORLD} from the dp={DP_WORLD} "
          f"checkpoint: {time.perf_counter() - t0:.1f} s with spawn; step "
          f"{[r['resumed_step'] for r in recs]} restored in "
          f"{[round(r['restore_s'], 3) for r in recs]} s; residual stacks "
          f"saved {len(before)}, restored {len(after)} (the rest zero); "
          f"sum over the replicas vs saved: max |diff| / norm {worst:.2e} "
          f"(tol {EF_SUM_RTOL:.0e}); next loss {recs[0]['loss'][0]:.6f}; "
          f"launches {recs[0]['launches'][0]} {recs[0]['flash_launches'][0]}",
          flush=True)
    if [r["resumed_step"] for r in recs] != [saved[0]["step"]] * len(recs):
        raise AssertionError("load_state restored another step")
    if worst > EF_SUM_RTOL or not set(before) <= set(after):
        raise AssertionError(f"the restored residuals' sum is {worst:.2e} "
                             "of the saved norm off, or a stack is missing")
    for r in recs:
        if not math.isfinite(r["loss"][0]) or r["params_agree"] != [True]:
            raise AssertionError(f"after load_state: loss {r['loss']}, "
                                 f"params agree {r['params_agree']}")
        if r["launches"][0] != want or \
                r["flash_launches"][0] != flash_per_step:
            raise AssertionError(f"the step after load_state launched "
                                 f"{r['launches'][0]}, expected {want}")
        for k in ring_launches:
            ring_launches[k] += r["launches"][0][k]
    return ring_launches, ranks


STEP_LINE = re.compile(r"^step=(\d+) loss=(\S+) launches=(\{.*\})$")
# the launcher's log lines that time the recovery: (name, text)
RECOVERY_EVENTS = (
    ("failure seen", "worker failure, exit codes"),
    ("persist begun", "save-on-failure: persisting shm step"),
    ("restart decided", "restarting workers in place"),
    ("worker started", "started 1 worker process(es), node_rank=0 restart=1"),
)


def reap_adopted(grace_s: float = 30.0) -> None:
    """Reap what a finished launcher left to this subreaper: the resource
    trackers of its agent and workers outlive them by a moment and then
    wait, exited, for their new parent, this process.  Whatever is still
    running after ``grace_s`` is left to stop_processes."""
    import multiprocessing

    known = {p.pid for p in multiprocessing.active_children()}
    known.add(resource_tracker_pid())
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        left = [pid for pid in descendant_pids() if pid not in known]
        if not left:
            return
        for pid in left:
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:  # not ours (yet): a grandchild
                pass
        time.sleep(0.1)


def log_ts(line: str):
    """The wall-clock seconds of a launcher log line, or None."""
    m = re.match(r"\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3})\]", line)
    if not m:
        return None
    return (time.mktime(time.strptime(m.group(1), "%Y-%m-%d %H:%M:%S"))
            + int(m.group(2)) / 1e3)


def recovery_timeline(lines, crash_ts: float) -> str:
    """The recovery's events as seconds after the crash, from the agent's
    log lines and the resumed worker's ready_ts/load_s and resume_ts."""
    marks = []
    for name, text in RECOVERY_EVENTS:
        for line in lines:
            if text in line and log_ts(line) is not None:
                marks.append((name, log_ts(line) - crash_ts))
                break
    ready = [line for line in lines if line.startswith("ready_ts=")]
    if len(ready) == 2:
        fields = dict(f.split("=") for f in ready[1].split())
        marks.append(("worker ready (restore "
                      f"{float(fields['load_s']):.2f} s)",
                      float(fields["ready_ts"]) - crash_ts))
    for line in lines:
        if line.startswith("resume_ts="):
            marks.append(("first step done",
                          float(line.split()[0].split("=")[1]) - crash_ts))
    return "; ".join(f"{name} +{s:.2f} s" for name, s in marks)


def launcher_phase(per_step: dict, state_bytes: int, plain: dict,
                   beside=None):
    """[launcher]: the recovery drill through the port's launcher at
    llama2_1b, run in a thread while this one runs ``beside()`` (a later
    phase whose memory fits beside the worker's, so that the script keeps
    within its time limit), or alone.  Every step's loss of both workers
    is held bitwise to ``plain``'s, [training]'s uninterrupted run.
    Returns the drill's flash launches over both workers' steps and
    recovery_s (named for the load it was taken under), and what
    ``beside`` returned."""
    import ast
    import shutil
    import tempfile

    from dlrover_tpu_torch.trainer.flash_checkpoint import bench

    check_shm(state_bytes + CKPT_META_MARGIN, "the worker's snapshot")
    free = shutil.disk_usage(tempfile.gettempdir()).free
    need = 2 * state_bytes
    print(f"  {tempfile.gettempdir()} free {free / 1e9:.1f} GB; two "
          f"persisted steps need {need / 1e9:.1f} GB", flush=True)
    if free < need:
        raise AssertionError(f"the temp dir's disk has {free / 1e9:.2f} GB "
                             f"free, the drill needs {need / 1e9:.2f} GB")
    fd, log_path = tempfile.mkstemp(prefix="chip_smoke_launcher_",
                                    suffix=".log")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(1) as pool:
            drill = pool.submit(
                bench.recovery_drill, timeout=900.0, platform="",
                preset="llama2_1b",
                extra_env={"DLROVER_TPU_MASTER_SERVICE_TYPE": "http"},
                log_path=log_path)
            try:
                beside_result = beside() if beside else None
            finally:
                result = drill.result()
        took = time.perf_counter() - t0
        with open(log_path) as f:
            output = f.read()
    finally:
        os.unlink(log_path)
        reap_adopted()
    print("[launcher] the drill's results"
          + (" (it ran beside the phases above)" if beside else ""),
          flush=True)
    lines = [line.strip() for line in output.splitlines()]
    if "recovery_error" in result:
        print("\n".join(lines[-60:]))
        raise AssertionError(f"the recovery drill failed: "
                             f"{result['recovery_error']}")
    for marker in (f"simulating crash at step {LAUNCHER_CRASH_STEP}",
                   f"resumed from step {LAUNCHER_CRASH_STEP - 1}",
                   f"done at step {LAUNCHER_STEPS}, loss="):
        if not any(line.startswith(marker) for line in lines):
            raise AssertionError(f"the launcher's output lacks {marker!r}")
    if not any("restarting workers in place" in line for line in lines):
        raise AssertionError("the agent did not restart the worker in place "
                             "through NodeFailureDiagnostician")
    # the snapshot the new worker resumes from came from a blocking memory
    # save (engine._save_to_memory's line; an async one stages behind the
    # step and would be torn by the crash one step later)
    saved = f"flash-ckpt memory snapshot step={LAUNCHER_CRASH_STEP - 1} blocked"
    if not any(saved in line for line in lines):
        raise AssertionError(f"the launcher's output lacks {saved!r}")
    crash = lines.index(f"simulating crash at step {LAUNCHER_CRASH_STEP}")
    runs = ([], [])  # (step, loss, launches) of each worker
    for i, line in enumerate(lines):
        m = STEP_LINE.match(line)
        if m:
            runs[i > crash].append((int(m.group(1)), float(m.group(2)),
                                    ast.literal_eval(m.group(3))))
    want_steps = (list(range(1, LAUNCHER_CRASH_STEP + 1)),
                  list(range(LAUNCHER_CRASH_STEP, LAUNCHER_STEPS + 1)))
    for run, want in zip(runs, want_steps):
        if [s for s, _, _ in run] != want:
            raise AssertionError(f"worker steps {[s for s, _, _ in run]}, "
                                 f"expected {want}")
        for step, loss, launched in run:
            want = plain["loss"][step - 1]
            if launched != per_step or loss != want:
                raise AssertionError(
                    f"step {step}: loss {loss!r}, [training]'s {want!r}; "
                    f"launched {launched}, expected {per_step}")
    print(f"  worker 1: steps 1-{LAUNCHER_CRASH_STEP}, worker 2: steps "
          f"{LAUNCHER_CRASH_STEP}-{LAUNCHER_STEPS}, each step {per_step}; "
          "every loss bitwise [training]'s same step: "
          f"{[loss for _, loss, _ in runs[0]]} before the crash, "
          f"{[loss for _, loss, _ in runs[1]]} after the restore",
          flush=True)
    for line in lines:
        if "save-on-failure" in line or "restarting workers" in line:
            print(f"  {line}")
    crash_ts = next(float(line.split("=")[1]) for line in lines
                    if line.startswith("crash_ts="))
    print(f"  after the crash: {recovery_timeline(lines, crash_ts)}")
    # beside the legs the host's cores and memory bandwidth are shared:
    # that recovery_s is named so, and the one to report is the drill's
    # alone (--launcher-alone)
    key = "recovery_s_beside_mesh_legs" if beside else "recovery_s"
    print(f"  {key}={result['recovery_s']} (resumed step "
          f"{result['recovery_resumed_step']}) on {card_line()}; the "
          f"phase took {took:.1f} s", flush=True)
    launched = {k: sum(r[2][k] for run in runs for r in run)
                for k in per_step}
    return {"launches": launched, key: result["recovery_s"],
            "phase_s": round(took, 1)}, beside_result


def main() -> int:
    import torch

    alone = sys.argv[1:] == ["--launcher-alone"]
    if sys.argv[1:] and not alone:
        print(f"usage: {sys.argv[0]} [--launcher-alone]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    adopt_orphans()
    try:
        record = launcher_alone() if alone else run_phases()
    finally:
        stop_processes()
    print(json.dumps({"launcher": record} if alone else {"kernels": record}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def launcher_alone() -> dict:
    """``--launcher-alone``: the build, [training] (the uninterrupted run
    the workers' losses are held to) and [launcher] with nothing beside
    it, so that its recovery_s is the drill's own.  Returns the
    [launcher] record."""
    import torch

    from dlrover_tpu_torch.ops.cuda import _build
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.trainer.flash_checkpoint.bench import state_nbytes

    print(f"[device] {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    os.environ.update(SCOPES_OFF)
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    print("[training]", flush=True)
    _, trainer, state, batch, plain = train(fa)
    layers = trainer.model.config.num_layers
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
                "flash_bwd_dkv": layers}
    state_bytes = state_nbytes(state)
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    print("[launcher] (alone)", flush=True)
    record, _ = launcher_phase(per_step, state_bytes, plain)
    return record


def run_phases() -> list:
    """Every phase in order; returns the kernels' record."""
    import torch

    from dlrover_tpu_torch.ops.cuda import _build
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    print(f"[device] {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    os.environ.update(SCOPES_OFF)
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for source in _build.SOURCES:
        print_build_report(_build.build_log(source))

    sass = {}
    for source in _build.SOURCES:
        for kernel, counts in sass_counts(
                _build, _build.library_path(source)).items():
            sass[kernel] = counts
            print(f"  {kernel} SASS: {counts}")
    for kernel in SASS_KERNEL.values():  # wgmma and TMA, no mma.sync
        ops = sass[kernel]
        if not (ops["HGMMA"] and ops["UTMALDG"]) or ops["HMMA"]:
            raise AssertionError(f"{kernel} SASS: {ops}; expected wgmma and "
                                 "TMA loads and no mma.sync")

    print("[kernels vs plain versions]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in FLASH_SHAPES:
        errors = check_kernels(fa, gen, *shape)  # the training shape's last
    check_model_logits()

    print("[kernel timing, B=4 S=2048 H=16 D=128 causal]", flush=True)
    timings = time_kernels(fa, gen)
    print("[kernel timing, the cp=2 off-diagonal block: B=4 S=1024 H=16 "
          "D=128 not causal]", flush=True)
    off_diagonal = time_kernels(fa, gen, TRAIN_S // 2, causal=False)

    print("[training]", flush=True)
    launches, trainer, state, batch, plain = train(fa)

    print("[flash checkpoint]", flush=True)
    ckpt_record = flash_checkpoint(
        fa, trainer, state, batch,
        {"flash_fwd": 2 * trainer.model.config.num_layers,
         "flash_bwd_dq": trainer.model.config.num_layers,
         "flash_bwd_dkv": trainer.model.config.num_layers})
    print(json.dumps({"ckpt": ckpt_record}), flush=True)
    print("[dist persist]", flush=True)
    peer_record = {}

    def peer_phase(*args):
        print("[peer restore]", flush=True)
        peer_record.update(peer_restore_phase(fa, batch, *args))

    dist_record = dist_persist_phase(
        fa, trainer, state, batch,
        {"flash_fwd": 2 * trainer.model.config.num_layers,
         "flash_bwd_dq": trainer.model.config.num_layers,
         "flash_bwd_dkv": trainer.model.config.num_layers}, then=peer_phase)
    print(json.dumps({"dist_persist": dist_record}), flush=True)
    print(json.dumps({"peer_restore": peer_record}), flush=True)
    peer_launches = {k: peer_record["peer"]["launches"][k]
                     + peer_record["manifest"]["launches"][k]
                     for k in REPLACES}
    print("[dist bench]", flush=True)
    dist_bench_phase()
    per_step = {"flash_fwd": 2 * trainer.model.config.num_layers,
                "flash_bwd_dq": trainer.model.config.num_layers,
                "flash_bwd_dkv": trainer.model.config.num_layers}
    from dlrover_tpu_torch.trainer.flash_checkpoint.bench import state_nbytes

    state_bytes = state_nbytes(state)
    del trainer, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    print("[telemetry]", flush=True)
    telemetry = telemetry_phase(fa, plain)
    print(json.dumps({"telemetry": telemetry}), flush=True)
    # the mesh's processes need the card's memory: release what the
    # single-device phases left in this process's caching allocator
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] (this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB)", flush=True)
    mesh_launches, legs = mesh_phase(plain)
    # the launcher's worker takes ~35 GB of the card, the legs' ranks ~16
    # at once (a world-1 worker's ~35 beside it would leave too little):
    # its drill runs beside the legs
    print("[launcher] (its drill runs beside the [mesh] legs)", flush=True)
    t0 = time.perf_counter()
    launcher, ckpt_launches = launcher_phase(per_step, state_bytes, plain,
                                             beside=legs)
    print(json.dumps({"launcher": launcher}), flush=True)
    print(f"  [launcher] and the [mesh] legs took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print("[moe]", flush=True)
    moe_launches = moe_phase(fa)
    print("[ep] and [cp]", flush=True)
    t0 = time.perf_counter()
    cp_launches = ep_cp_phase()
    print(f"  [ep] and [cp] took {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, phase in (("gpt", gpt_phase), ("vit", vit_phase)):
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        phase()
        print(f"  [{name}] took {time.perf_counter() - t0:.1f} s",
              flush=True)
    print("[pp]", flush=True)
    t0 = time.perf_counter()
    pp_launches = pp_phase()
    print(f"  [pp] took {time.perf_counter() - t0:.1f} s; flash launches "
          f"over every rank's steps {pp_launches}", flush=True)

    from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as rrs

    print("[ring kernels vs plain versions, edge inputs]", flush=True)
    ring_errors = {}
    check_ring_kernels(rrs, [(2, 32, 256), (2, 16, 512), (1, 8, 1024)],
                       ring_errors)

    from dlrover_tpu_torch.ops.cuda import rdma_ring as rdma

    print("[ring add vs plain]", flush=True)
    check_ring_add(rrs, ring_errors)

    print("[rdma ring on one card vs plain]", flush=True)
    check_rdma_timeout(rdma)
    rdma_launches = check_rdma_ring(rdma, ring_errors)
    rdma_timing = time_rdma_ring(rdma)

    # the ranks need the card's memory: release what the single-device
    # phases left in this process's caching allocator
    gc.collect()
    torch.cuda.empty_cache()
    print("[peer window across processes]", flush=True)
    peer_window_leg()
    print(f"[dp leg: {DP_WORLD} ranks on one card] (this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB)", flush=True)
    t0 = time.perf_counter()
    ring_launches, widths, resume_launches, resumed, probe_launches = dp_leg()
    print(f"  [dp leg] took {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"[replica: {REPLICA_WORLD} ranks on one card, in the spawn of the "
          "dp leg's load_state]", flush=True)
    replica_launches = check_replica(resumed)

    block = 256
    largest, smallest = max(widths), min(widths)
    shapes = [(DP_WORLD, -(-w // block), block) for w in (largest, smallest)]
    print(f"[ring kernels at the dp leg's bucket shapes: rows of {largest} "
          f"and {smallest}]", flush=True)
    check_ring_kernels(rrs, shapes, ring_errors)
    ring_timings = time_ring_kernels(rrs, *shapes[0])
    time_ring_kernels(rrs, *shapes[1])
    add_timing = time_hop_add(rrs, largest)

    record = [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=REPLACES[name], launches=launches[name],
             max_abs_err=errors[name][0], atol=errors[name][1],
             rel_err=errors[name][2], rel_tol=REL_TOL,
             launches_mesh=mesh_launches[name],
             launches_ckpt=ckpt_launches[name],
             launches_moe=moe_launches[name],
             launches_pp=pp_launches[name],
             launches_peer_restore=peer_launches[name],
             launches_launcher=launcher["launches"][name],
             launches_replica=replica_launches[name],
             launches_cp=cp_launches[name],
             off_diagonal=off_diagonal[name],
             sass=sass[SASS_KERNEL[name]], **timings[name])
        for name in REPLACES
    ] + [
        dict(name=name, route="cuda", source=RING_SOURCE,
             replaces=RING_REPLACES[name], launches=ring_launches[name],
             launches_comm_probe=probe_launches[name],
             launches_load_state=resume_launches[name],
             launches_replica=replica_launches[name],
             max_abs_err=ring_errors[name], atol=0.0,
             **ring_timings[name])
        for name in RING_REPLACES
    ] + [
        dict(name="ring_add", route="cuda", source=RING_SOURCE,
             replaces=ADD_REPLACES, launches=ring_launches["add"],
             launches_replica=replica_launches["add"],
             max_abs_err=ring_errors["ring_add"], atol=0.0, **add_timing),
        dict(name="rdma_ring", route="cuda", source=RDMA_SOURCE,
             replaces=RDMA_REPLACES, launches=rdma_launches,
             launches_dp_leg=ring_launches["rdma_ring"],
             max_abs_err=ring_errors["rdma_ring"], atol=0.0, **rdma_timing),
    ]
    return record


if __name__ == "__main__":
    sys.exit(main())
