#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dlrover_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from dlrover_tpu_torch/csrc (nvcc, at first use),
then runs, in order, failing on the first phase that fails:

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
   GQA 4:1 and at the training shape (B=4, S=2048, H=16, D=128); forward
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
   the dQ and dK/dV kernels;
4. training: Llama-2-1B at full width and depth (22 layers), flash
   attention, B=4, S=2048 from a seeded numpy batch, AdamW with bf16
   moments, bf16 grads on fp32 masters; one warm-up step and 4 timed
   steps, each with a finite loss and the kernel launch counts a step
   must make (2 forwards per layer with remat, one dQ and one dK/dV);
   the mean, median and shortest step; then one more step under
   torch.profiler for the device time by phase and by kernel family, and
   the device's busy share of the median step;
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
   widths {128, 4096, 1,048,576}, and W=4 at 16,384,000, each torch.equal
   to its plain version; then the kernel's one-card path:
   50 calls back to back at W=4, width 1,048,576, cycling through three
   inputs (so that a read of a slot left by the previous call would show),
   with the launch count read around them and every output equal to plain;
   then its time at W=4, width 16,384,000 beside its bound (the bytes the
   function needs: each rank's buffer read once, each row written once)
   and torch.sum(xs, 0);
8. peer window across processes: 4 gloo ranks on the card build a
   PeerWindow (cudaMalloc windows, IPC handles exchanged with all_gather)
   and each copies a seeded row into its right neighbour's slot through
   the opened handle (copies only: no kernel waits on another process);
   each slot must hold its left neighbour's row exactly;
9. the dp leg: 4 rank processes on the one card over a gloo group (the
   exchange is host-staged), Llama-2-1B at full width with its depth cut
   to 4 layers, B=1 per rank, S=2048, bf16 grads on fp32 masters, bucket
   4 MB, transport ring_pallas_q: int8_sharded (1 warm-up and 3 timed
   steps), int4_sharded, blockwise_sharded and exact_sharded (3 steps
   each), then exact_sharded over the ring_pallas tier (3 steps), all
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
   from 2 forwards, one dQ and one dK/dV per layer;
10. the ring kernels at the dp leg's largest and smallest bucket shapes:
   torch.equal against the plain versions (the JSON line's max_abs_err is
   the largest |kernel - plain| over every comparison), then time per
   launch with CUDA events beside the bound (bytes over 3.35 TB/s) and
   the plain version; the hop add at the largest row like for like, in
   turns (kernel, torch, torch, kernel): in place, as the ring runs it,
   beside torch.add(a, b, out=a) (its ``library_ms``), and out of place
   beside torch.add(a, b) (``ms_out_of_place``, ``library_ms_out_of_place``).

The last three lines are the kernels' JSON record (each flash kernel's
with its D=128 instance's SASS counts under ``sass``), the nvidia-smi line and
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` is its count
over the path that runs it here: the single-device training (flash), the
dp leg (the ring_pallas_q and ring_pallas kernels), and for the rdma ring
its one-card path (``launches_dp_leg`` beside it: 0, as the dp leg's ranks
share the card).  Without a CUDA device it exits 1 and prints no result.
"""

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time

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
# (B, S, H, H_kv, D, causal) of the kernel-vs-plain checks: small shapes
# (causal and not, GQA 4:2, head_dim 64 and 128); off the 128-row tiles:
# below one tile, ragged (a multiple of neither 64 nor 128), the ragged
# last tile at D=128, and S a multiple of 64 but not of 128 (the last
# 128-row tile half past S: one of dQ's two warpgroups has no row to
# compute); S=2048 with GQA 4:1; the training shape last
FLASH_SHAPES = tuple((2, 256, 4, 2, D, causal) for D in (64, 128)
                     for causal in (True, False)) + (
    (2, 80, 4, 2, 64, True), (2, 333, 8, 2, 64, False),
    (1, 200, 4, 4, 128, True), (2, 192, 4, 2, 128, True),
    (1, TRAIN_S, 16, 4, 128, True), (TRAIN_B, TRAIN_S, 16, 16, 128, True))
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
RDMA_SHAPES = tuple((w, n) for w in (2, 4, 8)
                    for n in (128, 4096, 1_048_576)) + ((4, DP_LARGEST_ROW),)
RDMA_REUSE_CALLS, RDMA_REUSE_SHAPE = 50, (4, 1_048_576)
# the stuck-peer check's wait limit (the windows' default is a minute)
RDMA_TIMEOUT_S = 2.0
PEER_WINDOW_WIDTH = 1_048_576
DP_WORLD, DP_LAYERS, DP_BUCKET_MB = 4, 4, 4.0
# (run, mode, transport, steps): the schedule's lr is 0 at step 0, so a
# loss from step 2 on is the first to see an update
DP_RUNS = (("int8_sharded", "int8_sharded", "ring_pallas_q", 4),
           ("int4_sharded", "int4_sharded", "ring_pallas_q", 3),
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


def time_kernels(fa, gen):
    import torch
    import torch.nn.functional as F

    B, S, H, D = TRAIN_B, TRAIN_S, 16, 128
    q, k, v, do = rand_qkv(gen, B, S, H, H, D)
    out, lse = fa.flash_forward(q, k, v, True)
    delta = fa.attention_delta(out, do)
    pairs, t_bytes, r_bytes = attention_work(B, S, H, D, True)
    runs = {
        # name: (kernel, plain, flops, bytes read + written)
        "flash_fwd": (
            lambda: fa.flash_forward(q, k, v, True),
            lambda: fa.flash_forward_plain(q, k, v, True),
            4 * D * pairs, 4 * t_bytes + r_bytes),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True),
            6 * D * pairs, 5 * t_bytes + 2 * r_bytes),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True),
            8 * D * pairs, 6 * t_bytes + 2 * r_bytes),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        iters=20)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(
            dot)

    sdpa_fwd_bwd_ms = cuda_time_ms(sdpa_fwd_bwd, iters=10)
    # the backward alone: one forward kept, its graph walked again per call
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
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
    print(f"  F.scaled_dot_product_attention(is_causal=True): forward "
          f"{sdpa_fwd_ms:.4f} ms, backward alone {sdpa_bwd_ms:.4f} ms, "
          f"forward+backward {sdpa_fwd_bwd_ms:.4f} ms; port dQ+dK/dV "
          f"{timings['flash_bwd_dq']['ms'] + timings['flash_bwd_dkv']['ms']:.4f}"
          f" ms, forward+dQ+dK/dV "
          f"{sum(t['ms'] for t in timings.values()):.4f} ms")
    return timings


def train(fa):
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    cfg = LlamaConfig.llama2_1b(max_seq_len=TRAIN_S, attention_impl="flash")
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    n_params = model.num_params()
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
    print(f"  llama2_1b: {n_params / 1e9:.3f}B params, {cfg.num_layers} "
          f"layers, hidden {cfg.hidden_size}, heads {cfg.num_heads}x"
          f"{cfg.head_dim}, vocab {cfg.vocab_size}; B={TRAIN_B} S={TRAIN_S}")
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    torch.cuda.synchronize()
    fa.reset_launches()
    for step in range(1 + TIMED_STEPS):
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
    return launches


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
               and not e.name.startswith("trainer.")]
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
    # a CPU span's device time counts the kernels its own thread launched:
    # the forward under trainer.forward_backward (the backward, remat
    # recompute included, runs on autograd's device thread) and the whole
    # optimizer update under trainer.update
    spans = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith("trainer.")}
    forward = spans.get("trainer.forward_backward", 0.0)
    update = spans.get("trainer.update", 0.0)
    print(f"  profiled step: device busy {busy_ms:.1f} ms = "
          f"{busy_ms / (step_s * 1e3):.3f} of the {step_s * 1e3:.1f} ms "
          f"median step"
          f" (idle share {1 - busy_ms / (step_s * 1e3):.3f})")
    print(f"    forward {forward:.1f} ms, backward with remat recompute "
          f"{busy_ms - forward - update:.1f} ms, optimizer update "
          f"{update:.1f} ms")
    for family, ms in families.most_common():
        print(f"    {family}: {ms:.1f} ms ({ms / busy_ms:.3f} of busy)")
    for name, ms in by_name.most_common(8):
        print(f"    top kernel {ms:8.2f} ms  {name[:100]}")
    return state


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
    version at every shape; then its one-card path, counted; returns that
    path's launch count."""
    import torch

    for world, width in RDMA_SHAPES:
        xs = rdma_inputs(world, width, seed=world * 7 + width)
        want = rdma.rdma_ring_plain(xs)
        with rdma.OneCardWindows(xs.device, world, width) as windows:
            got = rdma.rdma_ring_one_card(xs, windows)
            windows.check()
        diff = max_abs(got, want)
        errors["rdma_ring"] = max(errors.get("rdma_ring", 0.0), diff)
        if not torch.equal(got, want):
            raise AssertionError(f"rdma_ring differs from the plain version "
                                 f"at W={world} width={width}: max abs {diff}")
        print(f"  W={world} width={width}: equal to plain")
        del xs, want, got
    world, width = RDMA_REUSE_SHAPE
    inputs = [rdma_inputs(world, width, seed=100 + k) for k in range(3)]
    wants = [rdma.rdma_ring_plain(xs) for xs in inputs]
    with rdma.OneCardWindows(inputs[0].device, world, width) as windows:
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
          f"W={world} width={width} (three inputs in turn), launches "
          f"{launches}, every output equal to plain")
    return launches


def check_rdma_timeout(rdma):
    """A stuck peer gives an error, never a hang: skipping generations on
    the one-card windows leaves every CTA's entry barrier short of its
    count, so each wait runs out and check() raises.  A second call queued
    on the broken windows leaves at once: both take one timeout."""
    import torch

    xs = rdma_inputs(2, 128, seed=9)
    with rdma.OneCardWindows(xs.device, 2, 128,
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
    with rdma.OneCardWindows(xs.device, 2, 128) as windows:
        got = rdma.rdma_ring_one_card(xs, windows)
        windows.check()
    if not torch.equal(got, rdma.rdma_ring_plain(xs)):
        raise AssertionError("the call on fresh windows is wrong")
    print("  a call on fresh windows equals plain")


def time_rdma_ring(rdma):
    """The one-card ring's time at W=4 and the dp leg's largest row (the
    kernel alone: the wrapper only launches), beside its bound, its plain
    version and torch.sum over the ranks."""
    import torch

    world, width = 4, DP_LARGEST_ROW
    xs = rdma_inputs(world, width, seed=5)
    with rdma.OneCardWindows(xs.device, world, width) as windows:
        ms = cuda_time_ms(lambda: rdma.rdma_ring_one_card(xs, windows),
                          iters=10)
        windows.check()
    plain_ms = cuda_time_ms(lambda: rdma.rdma_ring_plain(xs), iters=3,
                            warmup=1)
    library_ms = cuda_time_ms(lambda: torch.sum(xs, 0), iters=10)
    # the function reads every rank's (W, width) buffer once and writes
    # every rank's row once
    nbytes = (world + 1) * world * width * 4
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    # the ring itself also writes each hop's packet and reads it back
    traffic = (3 * world - 1) * world * width * 4
    print(f"  rdma_ring_one_card at W={world} width={width}: {ms:.4f} ms  "
          f"bound {b_ms:.4f} ms (bytes, {nbytes / 1e9:.2f} GB)  plain "
          f"{plain_ms:.4f} ms  torch.sum(xs, 0) {library_ms:.4f} ms; the "
          f"ring's own traffic {traffic / 1e9:.2f} GB, "
          f"{traffic / PEAK_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes",
                library_ms=library_ms)


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
              f"{r['ctas']} CTAs; slot 0 equal to the left neighbour's row: "
              f"{r['equal']} (max abs {r['max_abs_err']})")
        if not r["equal"]:
            raise AssertionError(f"rank {r['rank']}'s slot does not hold its "
                                 "left neighbour's row")
    print(f"  {DP_WORLD} processes, IPC-opened windows, "
          f"{time.perf_counter() - t0:.1f} s with spawn")


def expected_ring_launches(mode: str, transport: str, widths,
                           names) -> dict:
    """The ring kernels' launches one dp step must make on each rank."""
    want = {name: 0 for name in names}
    n_buckets = len(widths)
    if mode.startswith(("int8", "int4", "blockwise")):
        enc, acc = (("q8_encode", "q8_accum") if mode.startswith("int8")
                    else ("q4_encode", "q4_accum"))
        want[enc], want[acc] = n_buckets, n_buckets * (DP_WORLD - 1)
    elif transport == "ring_pallas":
        # the hop add runs where the width meets the tier's tiling rule;
        # the other buckets take the ring's plain add
        want["add"] = sum(w % 1024 == 0 for w in widths) * (DP_WORLD - 1)
    return want


def dp_leg():
    """The 4-rank data-parallel leg on the one card (phase 9)."""
    import numpy as np
    import torch

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
    print(f"  {DP_WORLD} rank processes share the one card over a gloo "
          f"group: every exchange is host-staged (device -> host -> "
          f"device); llama2_1b at full width, {DP_LAYERS} layers, B=1 per "
          f"rank, S={TRAIN_S}, bucket {DP_BUCKET_MB} MB; runs "
          f"{[(name, transport) for name, _, transport, _ in DP_RUNS]}",
          flush=True)
    t0 = time.perf_counter()
    ranks = process_group.spawn(dp_workers.train_worker, DP_WORLD, (spec,),
                                backend="gloo", device="cuda",
                                timeout_s=DP_TIMEOUT_S)
    print(f"  the leg took {time.perf_counter() - t0:.1f} s with spawn and "
          "model set-up", flush=True)
    records = {name: [r["runs"][name] for r in ranks]
               for name, _, _, _ in DP_RUNS}
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
        want = expected_ring_launches(mode, transport, widths, names)
        for rec in recs:
            if rec["summary"]["signature"] != summary["signature"]:
                raise AssertionError(f"{name}: ranks derived different "
                                     "bucket layouts")
            if rec["params_agree"] != [True] * steps:
                raise AssertionError(f"{name}: params not bit-identical "
                                     f"across ranks: {rec['params_agree']}")
            for step, counts in enumerate(rec["launches"]):
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
    return launches, widths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.ops.cuda import _build
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    print(f"[device] {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
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

    print("[training]", flush=True)
    launches = train(fa)

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
    ring_launches, widths = dp_leg()

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
             sass=sass[SASS_KERNEL[name]], **timings[name])
        for name in REPLACES
    ] + [
        dict(name=name, route="cuda", source=RING_SOURCE,
             replaces=RING_REPLACES[name], launches=ring_launches[name],
             max_abs_err=ring_errors[name], atol=0.0,
             **ring_timings[name])
        for name in RING_REPLACES
    ] + [
        dict(name="ring_add", route="cuda", source=RING_SOURCE,
             replaces=ADD_REPLACES, launches=ring_launches["add"],
             max_abs_err=ring_errors["ring_add"], atol=0.0, **add_timing),
        dict(name="rdma_ring", route="cuda", source=RDMA_SOURCE,
             replaces=RDMA_REPLACES, launches=rdma_launches,
             launches_dp_leg=ring_launches["rdma_ring"],
             max_abs_err=ring_errors["rdma_ring"], atol=0.0, **rdma_timing),
    ]
    print(json.dumps({"kernels": record}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
